"""Per-phase profile of the native CPU encode engine.

Times, per block of the bench corpus (the real-file assembly by
default): the native transform (BWT+MTF+RLE2), the native block CRC, and
the single-call native emission (refine + headers + payload + pack) —
the three legs a CPU-engine optimization must target. Best-of-N per
block, since host phase noise makes single runs misleading.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from bench import build_corpus, build_real_corpus
from tpubz.format.constants import block_budget
from tpubz.format.crc import block_crc
from tpubz.hostref.rle1 import rle1_blocks
from tpubz.native import get_lib, block_transform_native
from tpubz.block.emit import emit_block

assert get_lib() is not None

real = build_real_corpus(8)
corpus = real[0] if real is not None else build_corpus(8)
arr = np.frombuffer(corpus, np.uint8)
out, blocks = rle1_blocks(arr, block_budget(9))
print(f"{len(blocks)} blocks ({'real-files' if real else 'proxy'})")

tot = {"transform": [], "crc": [], "emit": []}
for o0, o1, i0, i1 in blocks:
    blk = out[o0:o1]
    best = {k: 1e9 for k in tot}
    for rep in range(5):
        t0 = time.time()
        key, rle2, freqs, used = block_transform_native(blk)
        t1 = time.time()
        crc = block_crc(arr[i0:i1])
        t2 = time.time()
        emit_block(key, rle2, rle2.size, freqs, used, crc).pack()
        t3 = time.time()
        for k, v in (("transform", t1 - t0), ("crc", t2 - t1), ("emit", t3 - t2)):
            best[k] = min(best[k], v)
    for k in tot:
        tot[k].append(best[k])
    print(
        f"transform {1e3*best['transform']:6.1f}  crc {1e3*best['crc']:5.2f}  "
        f"refine+emit {1e3*best['emit']:5.1f}"
    )

m = {k: 1e3 * float(np.mean(v)) for k, v in tot.items()}
total = sum(m.values())
print(
    f"mean/block: transform {m['transform']:.1f}  crc {m['crc']:.2f}  "
    f"refine+emit {m['emit']:.1f}  total {total:.1f} ms -> "
    f"{arr.size/1e3/(total*len(blocks)):.1f} MB/s/thread"
)
