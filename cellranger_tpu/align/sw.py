"""Banded Smith-Waterman rescue.

Refines candidate loci with gapped local alignment (the role STAR's
stitched-seed extension plays in the reference, cr_lib/src/aligner.rs:396):
the ungapped Kadane pass (aligner.py) handles substitution-only reads; reads
with indels score low there and are rescued here.

Formulation:
  * banded DP over read positions i: B[i][d] = H[i][i+d] for band offset
    d in [0, BAND). Diagonal move keeps d, vertical (read-consuming gap)
    reads d+1 of the previous row, horizontal (window-consuming gap) is a
    max-plus prefix scan within the row: hscan[d] = max_{d'<=d} pre[d'] -
    gp*(d-d') = cummax(pre + gp*idx) - gp*idx — one cummax per row instead
    of a sequential in-row loop.
  * linear gap penalty (SW_GAP_EXTEND); local alignment (floor at 0);
    running (best, end_i, end_d) tracked per read, ties to the smaller d
    and the earlier row.

`banded_sw` is a `lax.fori_loop` over the L read positions whose body works
on one [BAND, C] slab, which XLA fuses. `banded_sw_triton` is the same DP as
a Pallas kernel on the Triton route (one program per tile of reads, the band
held as BAND per-read vectors). On an H100 the kernel takes the fused
step's rescue from ~1.0 to ~0.25 ms (PERF.md), so `rescue_sw` runs it when
lowering for CUDA and the plain form elsewhere.

Traceback for CIGARs is data-dependent pointer chasing, so the device forms
return (score, end_i, end_d) and the few reads whose gapped score beats
their ungapped score get a tiny host DP for the CIGAR (pipeline/bam_out
wiring). `sw_traceback_host` is also the plain reference of the scores.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from ..constants import SW_MATCH_SCORE, SW_MISMATCH_SCORE, SW_GAP_EXTEND
from ..ops.scan import cummax

BAND = 16
GAP = -SW_GAP_EXTEND  # positive penalty
NEG = -(1 << 20)


@jax.jit
def banded_sw(read_codes, read_mask, win_codes, win_mask):
    """Batched banded SW.

    read_codes uint8 [B, L]; win_codes uint8 [B, W] with W = L + BAND
    (window starts BAND//2 before the candidate diagonal so indels in both
    directions stay in band). Returns (score, end_i, end_d) int32 [B].
    """
    B, L = read_codes.shape
    W = win_codes.shape[1]
    assert W == L + BAND, (W, L)
    rc = read_codes.astype(jnp.int32).T                   # [L, B]
    rm = read_mask.astype(bool).T
    wc = win_codes.astype(jnp.int32).T                    # [W, B]
    wm = win_mask.astype(bool).T
    gp_d = GAP * jnp.arange(BAND, dtype=jnp.int32)[:, None]
    neg_row = jnp.full((1, B), NEG, jnp.int32)

    def body(i, carry):
        h_prev, best, bi, bd = carry
        w = jax.lax.dynamic_slice_in_dim(wc, i, BAND, 0)  # [BAND, B]
        active = rm[i][None, :] & jax.lax.dynamic_slice_in_dim(wm, i, BAND, 0)
        s = jnp.where(w == rc[i][None, :], SW_MATCH_SCORE, SW_MISMATCH_SCORE)
        diag = h_prev + jnp.where(active, s, NEG)
        vert = jnp.concatenate([h_prev[1:], neg_row], axis=0) - GAP
        pre = jnp.maximum(jnp.maximum(diag, vert), 0)
        h_cur = jnp.where(active, cummax(pre + gp_d, axis=0) - gp_d, 0)
        row_best = jnp.max(h_cur, axis=0)
        row_d = jnp.argmax(h_cur, axis=0).astype(jnp.int32)  # first = min d
        better = row_best > best
        return (h_cur, jnp.where(better, row_best, best),
                jnp.where(better, i, bi), jnp.where(better, row_d, bd))

    z = jnp.zeros((B,), jnp.int32)
    _, best, bi, bd = jax.lax.fori_loop(
        0, L, body, (jnp.zeros((BAND, B), jnp.int32), z, z, z))
    return best, bi, bd


def _sw_triton_kernel(read_ref, win_ref, score_ref, endi_ref, endd_ref):
    """One tile of reads. read_ref [L, T] / win_ref [W, T] int32 hold the
    base code, or -1 where the mask is off; outputs are [T] int32.

    Triton tensors cannot be sliced along the band, and the route has no
    cummax, so the band is unrolled into BAND per-read vectors: the
    vertical move renames vectors and the in-row scan is a max chain."""
    from jax.experimental.pallas import triton as plgpu

    L = read_ref.shape[0]
    T = score_ref.shape[0]
    row = lambda ref, i: plgpu.load(ref.at[i, pl.ds(0, T)])

    def body(i, carry):
        h, w, best, bi, bd = carry
        r = row(read_ref, i)
        ract = r >= 0
        pre = []
        for d in range(BAND):
            active = ract & (w[d] >= 0)
            s = jnp.where(active, jnp.where(w[d] == r, SW_MATCH_SCORE,
                                            SW_MISMATCH_SCORE), NEG)
            vert = (h[d + 1] if d + 1 < BAND else NEG) - GAP
            pre.append(jnp.maximum(jnp.maximum(h[d] + s, vert), 0))
        run = pre[0]
        h_new = [jnp.where(ract & (w[0] >= 0), run, 0)]
        for d in range(1, BAND):
            run = jnp.maximum(pre[d], run - GAP)
            h_new.append(jnp.where(ract & (w[d] >= 0), run, 0))
        row_best, row_d = h_new[0], jnp.zeros_like(bd)
        for d in range(1, BAND):
            up = h_new[d] > row_best
            row_best = jnp.where(up, h_new[d], row_best)
            row_d = jnp.where(up, d, row_d)
        better = row_best > best
        w_next = tuple(w[1:]) + (row(win_ref, i + BAND),)
        return (tuple(h_new), w_next, jnp.where(better, row_best, best),
                jnp.where(better, i, bi), jnp.where(better, row_d, bd))

    z = jnp.zeros((T,), jnp.int32)
    w0 = tuple(row(win_ref, d) for d in range(BAND))
    _, _, best, bi, bd = jax.lax.fori_loop(
        0, L, body, ((z,) * BAND, w0, z, z, z))
    score_ref[...] = best
    endi_ref[...] = bi
    endd_ref[...] = bd


@functools.partial(jax.jit, static_argnames=("tile", "num_warps",
                                             "interpret"))
def banded_sw_triton(read_codes, read_mask, win_codes, win_mask, *,
                     tile: int = 32, num_warps: int = 1,
                     interpret: bool = False):
    """`banded_sw` as a Pallas kernel on the Triton route: one program per
    `tile` reads (a power of two), one thread per read. Reads and windows
    are transposed so each DP row is one coalesced load; the batch is
    padded to a multiple of the tile. Same outputs as `banded_sw`."""
    from jax.experimental.pallas import triton as plgpu

    B, L = read_codes.shape
    W = win_codes.shape[1]
    assert W == L + BAND, (W, L)
    nt = pl.cdiv(B, tile)
    pad = nt * tile - B

    def prep(codes, mask):
        x = jnp.where(mask.astype(bool), codes.astype(jnp.int32), -1)
        return jnp.pad(x, ((0, pad), (0, 0)), constant_values=-1).T

    rt = prep(read_codes, read_mask)                      # [L, nt*tile]
    wt = prep(win_codes, win_mask)                        # [W, nt*tile]
    out_spec = pl.BlockSpec((tile,), lambda t: (t,))
    score, endi, endd = pl.pallas_call(
        _sw_triton_kernel,
        grid=(nt,),
        in_specs=[pl.BlockSpec((L, tile), lambda t: (0, t)),
                  pl.BlockSpec((W, tile), lambda t: (0, t))],
        out_specs=(out_spec,) * 3,
        out_shape=(jax.ShapeDtypeStruct((nt * tile,), jnp.int32),) * 3,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="banded_sw_triton",
    )(rt, wt)
    return score[:B], endi[:B], endd[:B]


def rescue_sw(read_codes, read_mask, win_codes, win_mask):
    """The form the aligner runs: the Triton kernel where the program is
    lowered for a CUDA device (faster inside the fused step, PERF.md), the
    plain `lax` form on every other platform."""
    return jax.lax.platform_dependent(
        read_codes, read_mask, win_codes, win_mask,
        cuda=banded_sw_triton, default=banded_sw)


def sw_traceback_host(read: np.ndarray, rmask: np.ndarray,
                      win: np.ndarray, wmask: np.ndarray):
    """Host DP + traceback for one read (CIGAR refinement of indel reads).

    Returns (score, cigar [(len, op)] with ops M/I/D/S, read_start,
    win_start). Same scoring as the kernel (linear gaps).
    """
    L = len(read)
    W = len(win)
    H = np.zeros((L + 1, W + 1), np.int32)
    ptr = np.zeros((L + 1, W + 1), np.int8)  # 0 stop, 1 diag, 2 up(I), 3 left(D)
    best, bi, bj = 0, 0, 0
    # same band as the kernel: window position j in [i, i + BAND)
    for i in range(1, L + 1):
        if not rmask[i - 1]:
            continue
        for j in range(max(1, i), min(W + 1, i + BAND)):
            if not wmask[j - 1]:
                continue
            s = SW_MATCH_SCORE if read[i - 1] == win[j - 1] else SW_MISMATCH_SCORE
            cands = (H[i - 1, j - 1] + s, H[i - 1, j] - GAP, H[i, j - 1] - GAP, 0)
            k = int(np.argmax(cands))
            v = cands[k]
            H[i, j] = v
            ptr[i, j] = (1, 2, 3, 0)[k] if v > 0 else 0
            if v > best:
                best, bi, bj = v, i, j
    # traceback
    ops = []
    i, j = bi, bj
    while i > 0 and j > 0 and ptr[i, j] != 0:
        p = ptr[i, j]
        if p == 1:
            ops.append("M"); i -= 1; j -= 1
        elif p == 2:
            ops.append("I"); i -= 1
        else:
            ops.append("D"); j -= 1
    ops.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    return int(best), cigar, i, j
