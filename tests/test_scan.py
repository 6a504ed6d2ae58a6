"""ops.scan.cummax (log-doubling) equals numpy's running maximum."""

import numpy as np
import pytest

from cellranger_tpu.ops.scan import cummax


@pytest.mark.parametrize("shape,axis,reverse,dtype", [
    ((91,), 0, False, np.int32),
    ((7, 91), 1, False, np.int32),
    ((5, 3, 91), 2, True, np.int32),
    ((16, 33), 0, False, np.uint32),
    ((4, 17), -1, True, np.float32),
    ((1,), 0, False, np.int32),
])
def test_cummax_matches_numpy(shape, axis, reverse, dtype):
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    x = (rng.integers(-1000, 1000, shape) if dtype != np.uint32
         else rng.integers(0, 2**32, shape, dtype=np.uint64)).astype(dtype)
    want = np.flip(np.maximum.accumulate(np.flip(x, axis), axis=axis), axis) \
        if reverse else np.maximum.accumulate(x, axis=axis)
    np.testing.assert_array_equal(np.asarray(cummax(x, axis, reverse)), want)
