"""Where tpubz keeps JAX's persistent compile cache and the state beside it.

One directory holds the compile cache, the AOT warm stamps that say which
graphs it holds (block/encode.py, dist/sharded.py) and the measured rig
profile (stream/rigprofile.py). It is ``JAX_COMPILATION_CACHE_DIR`` when
that is set — JAX reads the variable itself, so code sets no other
directory — and otherwise the fixed ``<checkout>/.jax_cache``. A fixed
path lets every process of one checkout find what an earlier one compiled.
"""
from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )
