"""Device read trimming: TSO (5') and polyA (3') adapter removal.

The reference trims each RNA read before STAR alignment and restores the
trimmed bases as soft clips afterwards (lib/rust/cr_lib/src/aligner.rs:
101-166 adapter defs + score thresholds, :404 restore, cr_wrap default
min scores 20/20 at cellranger.rs:278-279).  Fixed-shape formulation: the
read buffer is NEVER moved — trimming masks bases out of `nmask`, the
aligner's seed/extension stages already skip masked bases (they behave
like N's), and the BAM CIGAR's soft-clip arithmetic restores the full
sequence automatically.  Both adapters score vectorized over the batch:

  * polyA (3', non-internal): the adapter is a homopolymer, so the best
    gapless local alignment against any read suffix is
    max_p [ #A in [p,L) − #non-A in [p,L) ] — one reversed cumsum.
  * TSO "AAGCAGTGGTATCAACGCAGAGTACATGGG" (5', anywhere): gapless sliding
    score over every overlap offset (+1 match / −1 mismatch, masked bases
    mismatch), trimming through the adapter's end.

Gapless scoring matches fastq_set's banded alignment on real adapters in
all but pathological indel-in-adapter cases (score threshold 20 of 30
tolerates 5 mismatches).  The TSO best score doubles as the `tso_frac`
metric signal (score >= 20, aligner.rs:180).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

TSO_SEQ = b"AAGCAGTGGTATCAACGCAGAGTACATGGG"   # aligner.rs:86
TSO_CODES = np.frombuffer(TSO_SEQ, np.uint8)
_CODE = {65: 0, 67: 1, 71: 2, 84: 3}
TSO_2BIT = np.asarray([_CODE[b] for b in TSO_CODES], np.int32)

DEFAULT_TRIM_MIN_SCORE = 20   # cellranger.rs:278-279
TSO_METRIC_MIN_SCORE = 20     # aligner.rs:180 MIN_TSO_SCORE


def make_trimmer(read_len: int, polya_min: int | None = DEFAULT_TRIM_MIN_SCORE,
                 tso_min: int | None = DEFAULT_TRIM_MIN_SCORE):
    """Build trim(rna, nmask) -> dict; all static shapes, jit-safe inline.

    Returns per-read: nmask (trimmed), retain_start, retain_end,
    tso_score, tso_trimmed, polya_trimmed.
    """
    L = read_len
    K = len(TSO_2BIT)
    # offsets of the adapter's first base relative to the read: -K+1 .. L-1
    D = L + K - 1
    d_of = jnp.arange(D, dtype=jnp.int32) - (K - 1)
    # in-read overlap length per offset (static)
    n_olap_np = np.asarray(
        [sum(1 for j in range(K) if 0 <= d + j < L)
         for d in (np.arange(D) - (K - 1))], np.int32)
    n_olap = jnp.asarray(n_olap_np)

    def trim(rna, nmask):
        B = rna.shape[0]
        # ---- polyA suffix score ----
        contrib = jnp.where(nmask, jnp.where(rna == 0, 1, -1), 0) \
            .astype(jnp.int32)
        suff = jnp.cumsum(contrib[:, ::-1], axis=1)[:, ::-1]   # [B, L] s(p)
        pa_best = jnp.max(suff, axis=1)
        # leftmost maximal suffix start (trim the longest qualifying run)
        pa_start = jnp.argmax(suff, axis=1).astype(jnp.int32)
        pa_hit = (pa_best >= polya_min) if polya_min is not None \
            else jnp.zeros((B,), bool)
        retain_end = jnp.where(pa_hit, pa_start, L)

        # ---- TSO sliding score: K shifted adds, no gathers ----
        # score[d] = 2 * #matches(read[d+j] == tso[j]) - overlap(d);
        # adapter base j contributes its per-position match vector shifted
        # so read position p lands at offset index p - j + K - 1.  XLA
        # fuses the K pad+add steps; cost is O(K*L) VPU adds per read.
        acc = jnp.zeros((B, D), jnp.int32)
        for j in range(K):
            m_j = ((rna == TSO_2BIT[j]) & nmask).astype(jnp.int32)  # [B, L]
            acc = acc.at[:, K - 1 - j:K - 1 - j + L].add(m_j)
        score_d = 2 * acc - n_olap[None, :]           # [B, D]
        ts_best = jnp.max(score_d, axis=1)
        d_best = d_of[jnp.argmax(score_d, axis=1)]
        ts_hit = (ts_best >= tso_min) if tso_min is not None \
            else jnp.zeros((B,), bool)
        retain_start = jnp.where(ts_hit, jnp.clip(d_best + K, 0, L), 0)

        retain_end = jnp.maximum(retain_end, retain_start)
        pos = jnp.arange(L, dtype=jnp.int32)[None, :]
        new_mask = nmask & (pos >= retain_start[:, None]) \
            & (pos < retain_end[:, None])
        return dict(
            nmask=new_mask,
            retain_start=retain_start,
            retain_end=retain_end,
            tso_score=ts_best,
            matched_tso=ts_best >= TSO_METRIC_MIN_SCORE,
            tso_trimmed=retain_start,
            polya_trimmed=L - retain_end,
        )

    return trim
