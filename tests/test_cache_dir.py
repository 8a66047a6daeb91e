"""Where the compile cache, the warm stamps and the rig profile live:
JAX_COMPILATION_CACHE_DIR when set (and code sets no other directory),
else <checkout>/.jax_cache. Each case runs in a fresh interpreter, since
JAX reads the variable once at start-up."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import os, jax
from tpubz.block.encode import _stamp_path, setup_jax_cache
from tpubz.dist.sharded import _sharded_stamp_path
from tpubz.stream import rigprofile
setup_jax_cache()
print(jax.config.jax_compilation_cache_dir)
print(os.path.dirname(_stamp_path()))
print(os.path.dirname(_sharded_stamp_path((4,), 4, 900096)))
print(os.path.dirname(rigprofile._path()))
"""


@pytest.mark.parametrize("env_set", [True, False], ids=["env-set", "env-unset"])
def test_cache_dir_rule(tmp_path, env_set):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env_set:
        want = str(tmp_path / "jaxcc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    p = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert p.returncode == 0, p.stderr[-800:]
    assert p.stdout.split() == [want] * 4
    assert os.path.isdir(want)
