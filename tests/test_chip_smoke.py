"""chip_smoke.py on the CPU: its phase functions at level 1 on small data,
and its refusal to run (and to print an ok line) without a GPU."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_kernel_phase_level1_matches_oracle(capsys):
    """Every stage graph at level 1 matches the host oracle on the three
    block classes; devrefine and the device inverse BWT run once."""
    chip_smoke.phase_kernels(levels=(1,))
    out = capsys.readouterr().out
    for b in ("mixed", "periodic", "random"):
        assert f"L1 {b} n=" in out
    assert out.count("all 6 graphs == host oracle") == 3
    assert "encode_block_devrefine == host emission" in out
    assert "kernels/ibwt.py inverse == original block" in out


def test_kernel_blocks_classes():
    """The periodic block needs long contexts and the random one reaches
    the symbols >= 256 sidecar; all are full width."""
    from tpubz.format.constants import block_budget

    blocks = chip_smoke.kernel_blocks(1)
    assert set(blocks) == {"mixed", "periodic", "random"}
    assert blocks["mixed"].size == blocks["random"].size == block_budget(1)
    p = blocks["periodic"]
    assert p.size == block_budget(1) // 1000 * 1000
    assert (p[1000:] != p[:-1000]).sum() == 2  # one changed byte
    assert np.unique(blocks["random"]).size == 256


def _no_ok_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return False
        except (ValueError, AttributeError):
            continue
    return True


def test_main_refuses_without_gpu(capsys):
    rc = chip_smoke.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert _no_ok_line(out)


def test_script_alone_fails_without_the_repo(tmp_path):
    """Copied into a directory with nothing else of the repository, the
    script exits non-zero and prints no ok line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0
    assert _no_ok_line(p.stdout)
