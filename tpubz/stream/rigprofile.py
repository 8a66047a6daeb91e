"""Measured per-rig routing profile.

Routing constants baked in from one machine's measurements would describe
only that machine. This module keeps a small persisted profile instead,
which the stream scheduler TRAINS as it runs and READS at startup:

  - cpu_block_s   — EMA of one native CPU-engine block (transform+refine+
                    emit) on this host, per worker thread
  - dev_cadence_s — per-stage ("bwt" / "full") EMA of the device pipeline's
                    per-block completion cadence (device + copies,
                    pipelined)
  - host_leg_s    — per-stage EMA of the host-side work each device block
                    still costs (bwt: native MTF/RLE2 + refine + emit;
                    full: refine + emit only)

The profile lives next to the compile cache and the AOT warm stamps
(tpubz/cache.py) because it describes the same host those stamps
describe. Env vars (TPUBZ_DEVICE_STAGE, TPUBZ_HYBRID_CPU, ...) remain
OVERRIDES; absent an override the scheduler
derives its choices from the profile via `choose_stage` below.

Reference analogue: the reference hardcodes its dispatch thresholds
(src/bwt_algorithms/bwt_sort.rs:29,39 — SA-IS complexity < 0.3, parallel
sort > 40k) because it targets one machine class; a codec that schedules
across a device, its copies, and a host pool has to measure instead.
"""
from __future__ import annotations

import json
import os
import threading
import time

_LOCK = threading.Lock()
_CACHE: dict | None = None

_EMA = 0.3  # update weight: recent streams dominate, one outlier doesn't


def _path() -> str:
    from ..cache import cache_dir

    return os.path.join(cache_dir(), "tpubz_rig_profile.json")


def load() -> dict:
    """The persisted profile (memoized; {} when none exists yet)."""
    global _CACHE
    with _LOCK:
        if _CACHE is None:
            try:
                with open(_path()) as f:
                    _CACHE = json.load(f)
            except (OSError, ValueError):
                _CACHE = {}
        return dict(_CACHE)


def update(**samples: float | dict) -> None:
    """Fold fresh measurements into the profile (EMA per leaf field) and
    persist. Nested dicts (per-stage fields) merge leaf-wise. Persisting is
    best-effort: an unwritable cache dir costs the training, not the run."""
    global _CACHE
    with _LOCK:
        if _CACHE is None:
            try:
                with open(_path()) as f:
                    _CACHE = json.load(f)
            except (OSError, ValueError):
                _CACHE = {}

        def fold(dst: dict, src: dict):
            for k, v in src.items():
                if isinstance(v, dict):
                    fold(dst.setdefault(k, {}), v)
                elif v and v > 0:
                    old = dst.get(k)
                    if not isinstance(old, (int, float)) or old <= 0:
                        dst[k] = v
                    else:
                        # regime change: a fresh measurement 5x away from
                        # the stored value marks a different operating
                        # point (phase shift, healed relay, one poisoned
                        # sample) — converge in 1-2 streams instead of
                        # creeping at the outlier-resistant weight
                        w = _EMA if old / 5 <= v <= old * 5 else 0.7
                        dst[k] = (1 - w) * old + w * v
        fold(_CACHE, samples)
        _CACHE["updated_at"] = time.time()
        try:
            os.makedirs(os.path.dirname(_path()), exist_ok=True)
            tmp = _path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(_CACHE, f)
            os.replace(tmp, _path())
        except OSError:
            pass


def reset_memo() -> None:
    """Drop the in-process memo (tests; a new cache directory)."""
    global _CACHE
    with _LOCK:
        _CACHE = None


def choose_stage(profile: dict, workers: int, eff_cores: int) -> str | None:
    """Pick the device stage ("bwt" or "full") from measured numbers.

    Model: the device route sustains rate_r = min(1/c_r, C/h_r) blocks/s,
    where c_r = device cadence of route r, h_r = host CPU the route still
    costs per device block, and C = usable cores — a throttled host caps
    the route at C/h_r no matter how fast the chip runs. With a hybrid CPU
    pool the leftover cores run whole CPU-engine blocks (H seconds each):

        total_r = rate_r + max(0, C - h_r * rate_r) / H     [blocks/s]

    Where host cores are plentiful and the bwt-only route's device
    cadence is the faster one, this picks "bwt". Where cores are scarce
    the saturation term dominates and "full" wins: it offloads MTF/RLE2
    onto the device, so the cores stretch over more device blocks.

    Returns None when the profile lacks the measurements to decide (caller
    keeps its generic default and the live arbitration trains the profile).
    """
    cad = profile.get("dev_cadence_s", {})
    leg = profile.get("host_leg_s", {})
    H = profile.get("cpu_block_s")
    routes = [
        s for s in ("bwt", "full") if cad.get(s) and leg.get(s) is not None
    ]
    if len(routes) < 2:
        return None
    C = max(1, eff_cores)

    def score(s: str) -> float:
        c, h = float(cad[s]), float(leg.get(s) or 0.0)
        rate = min(1.0 / c, C / h) if h > 0 else 1.0 / c
        if workers > 0 and H:
            return rate + max(0.0, C - h * rate) / float(H)
        return rate

    return max(routes, key=score)
