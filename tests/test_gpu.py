"""Kernels compiled for the card (no interpret mode), against the plain
reference at the widths the fused step uses. Skips without a GPU."""

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_triton_sw_matches_plain_at_real_width(gpu):
    import chip_smoke
    from cellranger_tpu.align.sw import banded_sw, banded_sw_triton

    args = jax.device_put(chip_smoke.sw_cases(8192 + 5, 91), gpu)
    want = [np.asarray(x) for x in banded_sw(*args)]
    got = [np.asarray(x) for x in banded_sw_triton(*args)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rescue_sw_runs_the_kernel_on_the_gpu(gpu):
    import chip_smoke
    from cellranger_tpu.align.sw import banded_sw, rescue_sw

    args = jax.device_put(chip_smoke.sw_cases(300, 91, seed=1), gpu)
    hlo = jax.jit(rescue_sw).lower(*args).as_text()
    assert "banded_sw_triton" in hlo
    for g, w in zip(jax.jit(rescue_sw)(*args), banded_sw(*args)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
