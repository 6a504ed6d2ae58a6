"""chip_smoke.py refuses to report a result without a GPU or without the
package beside it; its SW cases have the shapes the card run relies on."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script, "--phases", "1"], cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=300)
    lines = r.stdout.strip().splitlines()
    ok = False
    if lines:
        try:
            ok = json.loads(lines[-1]).get("ok") is True
        except ValueError:
            pass
    return r.returncode, ok


def test_refuses_a_cpu_only_device():
    rc, ok = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert rc != 0 and not ok


def test_fails_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    rc, ok = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert rc != 0 and not ok


def test_sw_cases_cover_indels_masks_and_padding():
    sys.path.insert(0, REPO)
    import chip_smoke
    from cellranger_tpu.align.sw import BAND, banded_sw, sw_traceback_host

    read, rmask, win, wmask = chip_smoke.sw_cases(70, 91, seed=3)
    assert read.shape == (70, 91) and win.shape == (70, 91 + BAND)
    assert chip_smoke.SW_READS >= 4096 and chip_smoke.SW_READS % 32
    assert not rmask[-1].any() and (~rmask).any() and (~wmask).any()
    got = np.asarray(banded_sw(read, rmask, win, wmask)[0])
    want = [sw_traceback_host(read[b], rmask[b], win[b], wmask[b])[0]
            for b in range(70)]
    np.testing.assert_array_equal(got, want)
