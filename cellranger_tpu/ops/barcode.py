"""Device barcode ops: whitelist membership + posterior Hamming-1 correction.

Batched device formulation of the reference's barcode machinery:
  * membership (barcode/src/whitelist.rs:494 check_and_update) becomes ONE
    bucket-row gather (ops.bucket_table) of the packed uint32 barcode
    against the whitelist resident in device memory, fully batched;
  * correction (barcode/src/corrector.rs:111-164, the `Posterior` strategy)
    becomes a dense [B, L, 3] candidate tensor: every 1-Hamming mutant is
    bc ^ (d << shift) for d in {1,2,3} in 2-bit code space, scored by
    P(error|qual) * (count+1) with Laplace smoothing, accepted when
    best/total >= 0.975 (corrector.rs:83). Ties on likelihood resolve to the
    lexicographically larger barcode, matching the reference's
    max((likelihood, bc)) tuple ordering (corrector.rs:144-148).
    The whitelist's observed-count prior is stored IN the table row
    (BucketTable.with_counts), so each of the 48 candidate probes costs
    exactly one row gather — the unit of gather cost.
    Callers compact the batch to invalid-barcode reads first
    (pipeline/count.py), so the 48-probe cost is paid only where needed.

All shapes static; everything under jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import (
    BARCODE_CONFIDENCE_THRESHOLD,
    BC_MAX_QV,
    ILLUMINA_QUAL_OFFSET,
)
from .bucket_table import BucketTable
from .lookup import SortedTable


def whitelist_lookup(packed: jnp.ndarray, wl):
    """Membership of packed barcodes in the whitelist.

    wl: BucketTable (one row gather), SortedTable, or a raw sorted uint32
    array (legacy binary search). Returns (is_member bool, index int32,
    -1 miss)."""
    if isinstance(wl, (SortedTable, BucketTable)):
        return wl.membership(packed)
    idx = jnp.searchsorted(wl, packed)
    idx_c = jnp.minimum(idx, wl.shape[0] - 1).astype(jnp.int32)
    hit = wl[idx_c] == packed
    return hit, jnp.where(hit, idx_c, -1)


def qual_error_prob(qual: jnp.ndarray) -> jnp.ndarray:
    """Phred ASCII qual -> error probability, capped at QV 66
    (corrector.rs:8,127,169-173)."""
    q = jnp.minimum(qual, BC_MAX_QV).astype(jnp.float32)
    return jnp.power(10.0, -(q - ILLUMINA_QUAL_OFFSET) / 10.0)


@functools.partial(jax.jit, static_argnames=("length",))
def correct_barcodes(
    packed: jnp.ndarray,      # uint32 [B] observed (invalid) barcodes
    quals: jnp.ndarray,       # uint8 [B, length] phred+33 quality values
    wl: BucketTable,          # whitelist table with counts column filled
    length: int,
):
    """Posterior 1-Hamming correction of a batch of non-whitelist barcodes.

    Returns (corrected_packed uint32 [B], corrected_idx int32 [B],
    accepted bool [B]). Unaccepted rows return the input barcode and idx -1.
    """
    B = packed.shape[0]
    # Candidate mutants: bc ^ (d << (2*(length-1-pos))) for d in 1..3.
    pos = jnp.arange(length, dtype=jnp.uint32)
    shifts = (2 * (length - 1 - pos)).astype(jnp.uint32)  # [L]
    d = jnp.arange(1, 4, dtype=jnp.uint32)  # [3]
    xor = (d[None, :] << shifts[:, None]).astype(jnp.uint32)  # [L, 3]
    cands = packed[:, None, None] ^ xor[None, :, :]  # [B, L, 3]

    # one row gather per candidate: membership + index + prior count
    is_member, idx, counts = wl.membership3(cands)  # [B, L, 3]

    prob_edit = qual_error_prob(quals)  # [B, L]
    # Laplace smoothing: likelihood = P(err) * (count + 1), members only.
    like = jnp.where(
        is_member, prob_edit[:, :, None] * (counts.astype(jnp.float32) + 1.0), 0.0
    )  # [B, L, 3]

    flat_like = like.reshape(B, -1)
    flat_cand = cands.reshape(B, -1)
    flat_idx = idx.reshape(B, -1)
    total = jnp.sum(flat_like, axis=1)

    # argmax over (likelihood, candidate value): strictly-greater likelihood
    # wins; equal likelihood resolves to larger packed barcode.
    max_like = jnp.max(flat_like, axis=1, keepdims=True)
    at_max = flat_like >= max_like
    best_cand_val = jnp.max(
        jnp.where(at_max, flat_cand, jnp.uint32(0)), axis=1
    )
    best_pos = jnp.argmax(
        jnp.where(at_max & (flat_cand == best_cand_val[:, None]), 1, 0), axis=1
    )
    take = lambda a: jnp.take_along_axis(a, best_pos[:, None], axis=1)[:, 0]
    best_like = take(flat_like)
    best_idx = take(flat_idx)
    best_cand = take(flat_cand)

    accepted = (total > 0) & (
        best_like / jnp.maximum(total, 1e-30) >= BARCODE_CONFIDENCE_THRESHOLD
    )
    out_bc = jnp.where(accepted, best_cand, packed)
    out_idx = jnp.where(accepted, best_idx, -1)
    return out_bc, out_idx, accepted


def host_resolve_barcodes(bc_packed, bc_qual, slot_valid, wl_sorted,
                          wl_counts, length: int):
    """HOST whitelist membership + posterior 1-Hamming correction — the
    numpy twin of `correct_barcodes` (corrector.rs:111-164 Posterior).

    Barcode resolution moved OFF the device in round 3: membership is one
    vectorized searchsorted against the sorted whitelist (~1M reads/s on
    one core), correction touches only the few % invalid reads, and doing
    both before upload removes the barcode-qual plane (16B/read), the
    whitelist HBM table, and the in-step correction capacity (plus its
    overflow retry) from the hot path entirely.  Device batches then carry
    a final `bc_idx` and the step does only alignment/annotation FLOPs.

    Args: bc_packed uint32 [B]; bc_qual uint8 [B, length] phred+33;
    slot_valid bool [B]; wl_sorted uint32 [W] ascending; wl_counts int [W]
    observed-count prior (pass-1 histogram).
    Returns (bc_idx int32 [B] — whitelist rank or -1, hit bool [B] —
    exact member, corrected bool [B], corrected_bc uint32 [B]).
    """
    import numpy as np

    bc_packed = np.asarray(bc_packed, np.uint32)
    B = len(bc_packed)
    W = len(wl_sorted)
    idx = np.searchsorted(wl_sorted, bc_packed)
    idxc = np.minimum(idx, W - 1)
    hit = (wl_sorted[idxc] == bc_packed) & slot_valid
    bc_idx = np.where(hit, idxc, -1).astype(np.int32)
    corrected = np.zeros(B, bool)
    corr_bc = bc_packed.copy()
    inv = np.flatnonzero(~hit & slot_valid)
    if len(inv):
        pos = np.arange(length, dtype=np.uint32)
        shifts = (2 * (length - 1 - pos)).astype(np.uint32)
        d = np.arange(1, 4, dtype=np.uint32)
        xor = (d[None, :] << shifts[:, None]).reshape(-1)       # [3L]
        cand = bc_packed[inv, None] ^ xor[None, :]              # [I, 3L]
        ci = np.searchsorted(wl_sorted, cand)
        cic = np.minimum(ci, W - 1)
        member = wl_sorted[cic] == cand
        q = np.minimum(np.asarray(bc_qual)[inv], BC_MAX_QV).astype(np.float32)
        prob = np.power(np.float32(10.0),
                        -(q - ILLUMINA_QUAL_OFFSET) / np.float32(10.0))
        prob3 = np.repeat(prob, 3, axis=1)                      # [I, 3L]
        cnts = np.where(member, np.asarray(wl_counts, np.float32)[cic], 0.0)
        like = np.where(member, prob3 * (cnts + np.float32(1.0)),
                        np.float32(0.0))
        total = like.sum(axis=1, dtype=np.float32)
        max_like = like.max(axis=1, keepdims=True)
        at_max = like >= max_like
        # ties on likelihood resolve to the larger packed barcode
        # (corrector.rs:144-148 max((likelihood, bc)))
        best_cand = np.max(np.where(at_max, cand, np.uint32(0)), axis=1)
        sel = at_max & (cand == best_cand[:, None])
        best_col = np.argmax(sel, axis=1)
        take = lambda a: a[np.arange(len(inv)), best_col]
        best_like = take(like)
        accepted = (total > 0) & (
            best_like / np.maximum(total, np.float32(1e-30))
            >= BARCODE_CONFIDENCE_THRESHOLD)
        rows = inv[accepted]
        corrected[rows] = True
        corr_bc[rows] = best_cand[accepted]
        bc_idx[rows] = take(cic)[accepted].astype(np.int32)
    return bc_idx, hit, corrected, corr_bc


def count_valid_barcodes(idx: jnp.ndarray, valid: jnp.ndarray, wl_size: int):
    """Histogram whitelist indices of valid reads -> int32 [W] counts.
    Device scatter-add (the 'bc_counts' prior for correction,
    corrector.rs:14-16)."""
    contrib = valid.astype(jnp.int32)
    return jnp.zeros((wl_size,), jnp.int32).at[jnp.maximum(idx, 0)].add(
        jnp.where(idx >= 0, contrib, 0)
    )
