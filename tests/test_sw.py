"""Banded SW (plain lax form and Triton-route kernel) vs the host DP."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cellranger_tpu.align.sw import (BAND, banded_sw, banded_sw_triton,
                                     rescue_sw, sw_traceback_host)
from cellranger_tpu.ops import encode

triton_interp = functools.partial(banded_sw_triton, interpret=True)


def prep_case(read: bytes, win: bytes, L: int):
    rc, rv = encode.encode_str(read)
    wc, wv = encode.encode_str(win)
    W = L + BAND
    r = np.zeros(L, np.uint8); rm = np.zeros(L, bool)
    w = np.zeros(W, np.uint8); wm = np.zeros(W, bool)
    r[:len(rc)] = rc[:L]; rm[:len(rc)] = rv[:L]
    w[:len(wc)] = wc[:W]; wm[:len(wc)] = wv[:W]
    return r, rm, w, wm


def stack(cases, L):
    B = len(cases)
    W = L + BAND
    rs = np.zeros((B, L), np.uint8); rms = np.zeros((B, L), bool)
    ws = np.zeros((B, W), np.uint8); wms = np.zeros((B, W), bool)
    for i, (r, rm, w, wm) in enumerate(cases):
        rs[i], rms[i], ws[i], wms[i] = r, rm, w, wm
    return tuple(jnp.asarray(a) for a in (rs, rms, ws, wms))


def run_batch(cases, L, fn=banded_sw):
    return tuple(np.asarray(x) for x in fn(*stack(cases, L)))


def random_cases(L, B, seed):
    """Mutated window fragments: substitutions, 1-3 base indels (some at
    the band edge), masked read/window tails and one all-masked read."""
    rng = np.random.default_rng(seed)
    cases = []
    for t in range(B):
        win = bytes(rng.choice(list(b"ACGT"), L + BAND).astype(np.uint8))
        # diagonal mid-band so small indels stay inside; every 5th case
        # sits at the band edge, where a deletion leaves the band
        off = 0 if t % 5 == 4 else int(rng.integers(4, BAND - 4))
        frag = bytearray(win[off:off + L])
        for _ in range(int(rng.integers(0, 6))):
            frag[int(rng.integers(L))] = int(rng.choice(list(b"ACGT")))
        k = int(rng.integers(1, 4))
        p = int(rng.integers(5, L - 5))
        if t % 3 == 1:
            del frag[p:p + k]; frag += b"A" * k
        elif t % 3 == 2:
            frag[p:p] = b"C" * k; del frag[L:]
        r, rm, w, wm = prep_case(bytes(frag), win, L)
        if t % 7 == 3:
            rm[int(rng.integers(L // 2, L)):] = False
        if t % 11 == 5:
            wm[int(rng.integers(L // 2, L + BAND)):] = False
        if t == B - 1:
            rm[:] = False
        cases.append((r, rm, w, wm))
    return cases


def test_exact_match():
    rng = np.random.default_rng(0)
    seq = bytes(rng.choice(list(b"ACGT"), 40).astype(np.uint8))
    win = b"AC" * (BAND // 4) + seq + b"GT" * 10
    c = prep_case(seq, win, 40)
    s, ei, ed = run_batch([c], 40)
    host_s, cig, ri, wi = sw_traceback_host(*c)
    assert s[0] == host_s == 40
    assert cig == [(40, "M")]


@pytest.mark.parametrize("L,B,seed", [(48, 64, 1), (48, 33, 2), (91, 37, 3),
                                      (91, 70, 4)])
def test_kernel_matches_host_random(L, B, seed):
    cases = random_cases(L, B, seed)
    expect = [sw_traceback_host(*c) for c in cases]
    s, ei, ed = run_batch(cases, L)
    np.testing.assert_array_equal(s, [e[0] for e in expect])
    assert s[-1] == 0                    # the all-masked read


def test_indel_read_scores_higher_with_gaps():
    rng = np.random.default_rng(5)
    g = bytes(rng.choice(list(b"ACGT"), 120).astype(np.uint8).astype(np.uint8))
    # read = window with a 2-base deletion in the middle
    win = g[:48 + BAND]
    read = g[BAND // 2:BAND // 2 + 20] + g[BAND // 2 + 22:BAND // 2 + 50]
    read = read[:48]
    c = prep_case(read, win, 48)
    s, ei, ed = run_batch([c], 48)
    host_s, cig, _, _ = sw_traceback_host(*c)
    assert s[0] == host_s
    ops = "".join(op for _, op in cig)
    assert "D" in ops
    # gapped score ~ 48 - deletion penalty; far better than ungapped (~20)
    assert s[0] >= 40


@pytest.mark.parametrize("L,B,tile", [(48, 33, 32), (91, 70, 32),
                                      (91, 64, 64)])
def test_triton_kernel_matches_plain(L, B, tile):
    """The Triton-route kernel (interpret mode here) returns the plain
    form's score, end row and end offset, batch padding included."""
    args = stack(random_cases(L, B, seed=L + B), L)
    want = [np.asarray(x) for x in banded_sw(*args)]
    got = [np.asarray(x) for x in triton_interp(*args, tile=tile)]
    for g, w in zip(got, want):
        assert g.shape == (B,)
        np.testing.assert_array_equal(g, w)


def test_end_position_agrees_with_host_traceback():
    cases = random_cases(48, 20, seed=9)
    s, ei, ed = run_batch(cases, 48)
    for c, sc, i, d in zip(cases, s, ei, ed):
        host_s, _, _, _ = sw_traceback_host(*c)
        if host_s > 0:
            # the host DP's first best cell, in 1-based (row, window) coords
            H_best = host_best_cell(*c)
            assert (i + 1, i + d + 1) == H_best


def host_best_cell(read, rmask, win, wmask):
    """First (row-major) cell holding the best score of the host DP."""
    from cellranger_tpu.align.sw import GAP
    from cellranger_tpu.constants import SW_MATCH_SCORE, SW_MISMATCH_SCORE
    L, W = len(read), len(win)
    H = np.zeros((L + 1, W + 1), np.int64)
    best, cell = 0, (0, 0)
    for i in range(1, L + 1):
        if not rmask[i - 1]:
            continue
        for j in range(max(1, i), min(W + 1, i + BAND)):
            if not wmask[j - 1]:
                continue
            s = SW_MATCH_SCORE if read[i - 1] == win[j - 1] else SW_MISMATCH_SCORE
            H[i, j] = max(H[i - 1, j - 1] + s, H[i - 1, j] - GAP,
                          H[i, j - 1] - GAP, 0)
            if H[i, j] > best:
                best, cell = H[i, j], (i, j)
    return cell


def test_rescue_sw_picks_triton_only_for_cuda():
    """The aligner's rescue lowers to the Triton kernel for CUDA and to
    the plain form for the CPU; on the CPU it equals the plain form."""
    shapes = (jax.ShapeDtypeStruct((64, 91), jnp.uint8),
              jax.ShapeDtypeStruct((64, 91), bool),
              jax.ShapeDtypeStruct((64, 91 + BAND), jnp.uint8),
              jax.ShapeDtypeStruct((64, 91 + BAND), bool))
    traced = jax.jit(rescue_sw).trace(*shapes)
    assert "banded_sw_triton" in traced.lower(
        lowering_platforms=("cuda",)).as_text()
    assert "banded_sw_triton" not in traced.lower(
        lowering_platforms=("cpu",)).as_text()
    args = stack(random_cases(91, 64, seed=11), 91)
    for a, b in zip(rescue_sw(*args), banded_sw(*args)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
