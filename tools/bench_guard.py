"""24 MB hybrid-vs-CPU-only regression guard.

The hybrid scheduler can lose to CPU-only when device blocks become
stream stragglers (for example when a stale AOT stamp demotes the device
route). The arbitration + straggler guard exist for that; this tool pins
the property that matters across device and host phases: the hybrid must
never be a liability. Trials interleave hybrid and CPU-only passes so a
phase swing mid-run biases both arms equally.

Run on a rig with a real accelerator:
    python tools/bench_guard.py [--mb 24] [--trials 3] [--tolerance 0.88]

Exit 0 = hybrid >= tolerance * cpu_only (and both outputs byte-identical);
exit 1 = regression. Prints one JSON line either way.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=24)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument(
        "--level",
        type=int,
        default=9,
        help="block size level (the CPU-backend contract test uses 1 so the "
        "device-route compile stays cheap)",
    )
    ap.add_argument(
        "--tolerance",
        type=float,
        default=0.88,
        help="hybrid must reach this fraction of CPU-only throughput "
        "(headroom for host phase noise)",
    )
    args = ap.parse_args()

    from bench import build_corpus
    from tpubz.stream.api import compress, compress_cpu

    corpus = build_corpus(args.mb)
    lvl = args.level

    # warm both arms (compiles, pools, scheduler EMAs)
    compress_cpu(corpus[: 1 << 20], lvl)
    compress(corpus[: 1 << 20], lvl)

    hyb_t, cpu_t = [], []
    hyb_out = cpu_out = None
    for _ in range(args.trials):
        t0 = time.time()
        hyb_out = compress(corpus, lvl)
        hyb_t.append(time.time() - t0)
        t0 = time.time()
        cpu_out = compress_cpu(corpus, lvl)
        cpu_t.append(time.time() - t0)

    assert hyb_out == cpu_out, "hybrid and CPU-only outputs must be identical"
    hyb = len(corpus) / statistics.median(hyb_t) / 1e6
    cpu = len(corpus) / statistics.median(cpu_t) / 1e6
    ok = hyb >= args.tolerance * cpu
    print(
        json.dumps(
            {
                "guard": "hybrid_not_liability_24mb",
                "mb": args.mb,
                "hybrid_MBps": round(hyb, 1),
                "cpu_only_MBps": round(cpu, 1),
                "ratio": round(hyb / cpu, 3),
                "tolerance": args.tolerance,
                "ok": ok,
            }
        )
    )
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
