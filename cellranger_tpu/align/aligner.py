"""Device seed-and-extend aligner (batched, fixed-shape, jit-compiled).

Device replacement for the reference's in-process STAR alignment
(cr_lib/src/stages/align_and_count.rs:588-592, cr_lib/src/aligner.rs:396-422):
instead of one C++ suffix-array walk per read on a CPU thread, we align a
whole fixed-shape batch at once. Random gathers from device memory are the
expensive operation, and a gather's cost follows the rows (memory
transactions) it touches more than their width, so every stage minimizes
row count:

  1. rolling 2-bit k-mer extraction at static seed offsets; each seed is
     CANONICALIZED (min of kmer and revcomp) so ONE bucket-row lookup
     serves both read strands — the hit strand is the stored strand bit
     XOR the query's flip bit;
  2. k-mer lookup via ops.bucket_table: one 64-byte row gather per seed
     surfaces up to E=8 candidate positions;
  3. diagonal voting: fused pairwise equality counting over the (strand,
     diagonal) keys + first-occurrence dedup, top-D candidates pooled
     ACROSS strands (no comparator sort);
  4. ungapped extension against genome windows fetched as ONE overlapped
     128-base-stride text row (two 256-base rows for wide windows),
     realigned in-register with log-shift selects and variable-shift word
     arithmetic; scored with Kadane max-substring via prefix scans —
     splice handling comes free from the index's junction contigs;
  5. canonicalized tie counting -> STAR MAPQ semantics
     (unique=255, 2 loci=3, 3-4=1, >4=0; rna_read.rs:32 HIGH_CONF_MAPQ);
  6. banded Smith-Waterman rescue (align/sw.py) runs only on the
     COMPACTED subset of reads whose ungapped score is below the map
     threshold (indel suspects), not the whole batch.

All steps are jnp ops on static shapes — XLA fuses the scoring chain; the
only sequential structure is log-depth scans.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_dataclass

from ..constants import DEFAULT_ALIGN_SCORE_MIN
from ..ops.bucket_table import BucketTable
from ..ops.encode import revcomp_packed
from ..ops.scan import cummax
from .index import GenomeIndex, MINIMIZER_HASH

# Tunables (static); see align_and_count.rs:63 for the score floor.
SEED_STRIDE = 10       # extract a seed every N bases of the read
MAX_HITS_PER_SEED = 8  # bucket-row width = max hits surfaced per seed
MAX_CANDIDATES = 3     # diagonals taken to extension, pooled across strands
                       # (the human-scale truth probe stays perfect at 3;
                       # saturation clips n_best to the STAR >4 bucket so
                       # MAPQ boundaries survive)
RESCUE_CAP_FRAC = 4    # SW rescue capacity = B // RESCUE_CAP_FRAC
RESCUE_MARGIN = 4      # rescue when ungapped score < valid_len - margin

# Novel splice junction discovery (STAR-analog split alignment; STAR
# defaults: alignIntronMin=21, winBinNbits-bounded intron max, and
# canonical-motif preference with noncanonical penalty)
SJ_MIN_INTRON = 21     # below this a gap is a deletion, not an intron
SJ_MAX_INTRON = 500_000
SJ_MIN_SEG = 12        # min per-side anchor score for a split alignment
SJ_MARGIN = 4          # spliced must beat the best unspliced by this
SJ_NONCANON_PEN = 8    # penalty when no GT..AG / CT..AC motif is found

# overlapped text rows cost ~0.9B/base of device memory next to the kmer
# table and halve the window row gathers; above this text size, windows
# fall back to the 2-row fetch.  The limit covers GRCh38 + junction
# contigs (a 2.6GB ov table in a ~13GB index).  Sites with less device
# memory can lower it via params.
OVERLAP_ROWS_MAX_TEXT = 3_400_000_000


@register_dataclass
@dataclass(frozen=True)
class DeviceIndex:
    """GenomeIndex uploaded to device (replicated; one copy per chip).

    Registered as a jax pytree so the big arrays pass through jit as
    ARGUMENTS, not closure constants: captured constants are embedded in
    the compiled program, which makes compiles slow and the compile cache
    key depend on the index contents."""

    text_rows: jnp.ndarray     # uint32 [NR+2, 32]: code words | valid words
    kmer_table: BucketTable    # canonical kmer -> packed pos/strand rows
    chrom_starts: jnp.ndarray  # int64 [C+1]
    sj_rows: jnp.ndarray       # uint32 [J, 2]: (donor_abs, acceptor_abs)
    # overlapped 128-base-stride rows (one gather serves any <=96-base
    # window); None for texts too big to spend the extra ~0.9B/base
    text_rows_ov: jnp.ndarray | None = None
    genome_len: int = field(metadata=dict(static=True), default=0)
    text_len: int = field(metadata=dict(static=True), default=0)
    sj_overhang: int = field(metadata=dict(static=True), default=120)
    k: int = field(metadata=dict(static=True), default=16)
    # position packing: "strand31" = pos|strand<<31 (exact, text < 2^31);
    # "parity" = (pos&~1)|strand (full u32 coords for human-scale text; the
    # aligner re-derives the exact start by scoring 4 window offsets)
    pos_mode: str = field(metadata=dict(static=True), default="strand31")
    sampling: str = field(metadata=dict(static=True), default="every")
    minimizer_w: int = field(metadata=dict(static=True), default=0)

    @staticmethod
    def _kmer_table_cached(gi: GenomeIndex) -> BucketTable:
        """Build (or sidecar-load) the kmer bucket table.  The placement
        argsorts every entry (~13min host time for GRCh38's 492M kmers),
        so indices loaded from disk cache the PLACED rows next to the
        npz, keyed on the entry count."""
        import os
        sp = getattr(gi, "source_path", None)
        side = f"{sp}.btrows.E{MAX_HITS_PER_SEED}.npz" if sp else None
        if side and os.path.exists(side):
            try:
                z = np.load(side, allow_pickle=False)
                if int(z["n_entries"]) == len(gi.kmer_keys):
                    return BucketTable(rows=jnp.asarray(z["rows"]),
                                       bits=int(z["bits"]),
                                       entries=MAX_HITS_PER_SEED, fields=2,
                                       probe_rows=1)
            except Exception:
                pass  # stale/corrupt sidecar: rebuild below
        rows, bits = BucketTable.build_rows(gi.kmer_keys, gi.kmer_pos,
                                            entries=MAX_HITS_PER_SEED,
                                            fields=2)
        if side:
            try:
                tmp = side + ".tmp.npz"
                np.savez(tmp, rows=rows, bits=bits,
                         n_entries=len(gi.kmer_keys))
                os.replace(tmp, side)
            except Exception:
                pass  # cache write is best-effort
        return BucketTable(rows=jnp.asarray(rows), bits=bits,
                           entries=MAX_HITS_PER_SEED, fields=2,
                           probe_rows=1)

    @staticmethod
    def from_host(gi: GenomeIndex) -> "DeviceIndex":
        assert len(gi.text) < 2**32, "u32 position space: text must be <4Gb"
        sj = np.stack([gi.sj_donor_end.astype(np.uint32),
                       gi.sj_acceptor_start.astype(np.uint32)], axis=1) \
            if gi.n_junctions else np.zeros((0, 2), np.uint32)
        from ..params import get as _param
        ov_max = int(_param("overlap_rows_max_text")
                     or OVERLAP_ROWS_MAX_TEXT)
        ov = (jnp.asarray(gi.packed_overlap_rows())
              if len(gi.text) <= ov_max else None)
        return DeviceIndex(
            text_rows=jnp.asarray(gi.packed_rows()),
            kmer_table=DeviceIndex._kmer_table_cached(gi),
            chrom_starts=jnp.asarray(gi.chrom_starts.astype(np.int64)),
            sj_rows=jnp.asarray(sj),
            text_rows_ov=ov,
            genome_len=int(gi.genome_len),
            text_len=len(gi.text),
            sj_overhang=int(gi.sj_overhang),
            k=gi.k,
            pos_mode=gi.pos_mode,
            sampling=gi.sampling,
            minimizer_w=int(gi.minimizer_w),
        )


def _rolling_kmers(codes: jnp.ndarray, k: int) -> jnp.ndarray:
    """codes uint8 [B, L] -> packed kmers uint32 [B, L-k+1] MSB-first."""
    B, L = codes.shape
    n = L - k + 1
    km = jnp.zeros((B, n), jnp.uint32)
    for i in range(k):
        km = (km << 2) | codes[:, i:i + n].astype(jnp.uint32)
    return km


def _window_valid(mask: jnp.ndarray, k: int) -> jnp.ndarray:
    """bool [B, L] -> [B, L-k+1]: all k bases valid (cumsum trick)."""
    cs = jnp.cumsum(mask.astype(jnp.int32), axis=1)
    cs = jnp.pad(cs, ((0, 0), (1, 0)))
    return (cs[:, k:] - cs[:, :-k]) == k


def _minimizer_picks(mh: jnp.ndarray, w: int) -> jnp.ndarray:
    """bool [B, n]: position i is the min of SOME w-window of mh — the
    identical rule to index.minimizer_mask, so every genome minimizer whose
    picking window lies inside the read is also picked here (the shared-seed
    guarantee of winnowing)."""
    n = mh.shape[1]
    w = min(w, n)
    if w <= 1:
        return jnp.ones(mh.shape, bool)

    def sweep(x, ww, op):  # out[:, j] = op-fold(x[:, j:j+ww]); log-doubling
        m = x
        have = 1
        while have < ww:
            step = min(have, ww - have)
            m = op(m[:, :m.shape[1] - step], m[:, step:])
            have += step
        return m

    # picked iff some covering window's min equals mh[i]: every covering
    # window min is <= mh[i], so test the window-MAX over window-mins
    wm = sweep(mh, w, jnp.minimum)                    # [B, n-w+1]
    pad = jnp.zeros((mh.shape[0], w - 1), mh.dtype)
    cover = sweep(jnp.concatenate([pad, wm, pad], 1), w, jnp.maximum)
    return mh == cover


OV_RW = 14  # overlapped-row words: covers 128-stride + <=96-base windows


def make_window_fetch(idx: "DeviceIndex", width: int):
    """Build fetch(idx, pos) -> (codes uint8 [..., width], valid bool).

    Windows are cut out IN REGISTERS: a log-shift select picks the word
    run and variable-shift word arithmetic lands the unpack exactly at
    pos.  Row fetches are the only HBM cost: with the overlapped table
    (text_rows_ov, 128-base stride) any <=96-base window is ONE gather;
    wider windows (SW rescue band) fall back to two 256-base-row gathers.
    """
    assert width <= 128
    n_words = (width + 15) // 16 + 1
    NR = int(idx.text_rows.shape[0])
    G = int(idx.text_len)
    # max word offset within an overlapped row is 7, so the window's
    # n_words must fit in the remaining OV_RW-7 words (width <= 96)
    use_ov = idx.text_rows_ov is not None and n_words <= OV_RW - 7
    R_ov = int(idx.text_rows_ov.shape[0]) if use_ov else 0

    def realign(words, vwords, pos, extra):
        # variable-shift word realignment: aligned word j =
        # (w[j] << 2*(pos&15)) | (w[j+1] >> 32-2*(pos&15))
        off2 = (2 * (pos & 15)).astype(jnp.uint32)[..., None]
        hi = words[..., :-1] << off2
        lo = jnp.where(off2 == 0, jnp.uint32(0),
                       words[..., 1:] >> jnp.minimum(32 - off2, 31))
        aligned = hi | lo
        off1 = ((pos & 15).astype(jnp.uint32))[..., None]
        vhi = (vwords[..., :-1] << off1) & jnp.uint32(0xFFFF)
        vlo = jnp.where(off1 == 0, jnp.uint32(0),
                        vwords[..., 1:] >> jnp.minimum(16 - off1, 15))
        valigned = vhi | vlo

        shifts = (2 * (15 - jnp.arange(16))).astype(jnp.uint32)
        codes16 = ((aligned[..., None] >> shifts) & 3).astype(jnp.uint8)
        vshifts = (15 - jnp.arange(16)).astype(jnp.uint32)
        valid16 = ((valigned[..., None] >> vshifts) & 1).astype(jnp.bool_)
        win = codes16.reshape(*pos.shape, (n_words - 1) * 16)[..., :width]
        wok = valid16.reshape(*pos.shape, (n_words - 1) * 16)[..., :width]
        in_bounds = (pos[..., None] + jnp.arange(width, dtype=jnp.uint32)
                     .reshape(*extra, -1)) < jnp.uint32(G)
        return win, wok & in_bounds

    def fetch_two_row(idx, pos):
        pos = pos.astype(jnp.uint32)       # full u32 coordinate space
        extra = (1,) * pos.ndim
        w0 = pos >> 4                      # first word index
        r = (w0 >> 4).astype(jnp.int32)    # row = 16 words (< 2^24 rows)
        rows_a = idx.text_rows[jnp.minimum(r, NR - 2)]       # [..., 32]
        rows_b = idx.text_rows[jnp.minimum(r + 1, NR - 1)]
        codes32 = jnp.concatenate([rows_a[..., :16], rows_b[..., :16]], -1)
        valid32 = jnp.concatenate([rows_a[..., 16:], rows_b[..., 16:]], -1)
        s = w0 & 15

        def shift_sel(arr):
            for b in (8, 4, 2, 1):
                cond = (s & b) > 0
                shifted = jnp.concatenate([arr[..., b:], arr[..., -b:]], -1)
                arr = jnp.where(cond[..., None], shifted, arr)
            return arr[..., :n_words]

        return realign(shift_sel(codes32), shift_sel(valid32), pos, extra)

    def fetch_overlap(idx, pos):
        pos = pos.astype(jnp.uint32)
        extra = (1,) * pos.ndim
        r = (pos >> 7).astype(jnp.int32)
        row = idx.text_rows_ov[jnp.minimum(r, R_ov - 1)]     # [..., 2*RW]
        codes = row[..., :OV_RW]
        valid = row[..., OV_RW:]
        s = (pos >> 4) & 7                 # word offset within the row

        def shift_sel(arr):
            for b in (4, 2, 1):
                cond = (s & b) > 0
                shifted = jnp.concatenate([arr[..., b:], arr[..., -b:]], -1)
                arr = jnp.where(cond[..., None], shifted, arr)
            return arr[..., :n_words]

        return realign(shift_sel(codes), shift_sel(valid), pos, extra)

    return fetch_overlap if use_ov else fetch_two_row


def make_aligner(idx: DeviceIndex, read_len: int,
                 score_min: int = DEFAULT_ALIGN_SCORE_MIN,
                 sw_rescue: bool = True, bind: bool = True,
                 novel_sj: bool = True, shard_axis: str | None = None):
    """Build the jitted batch alignment function for a static read length.

    shard_axis: when set, the function is being traced inside a shard_map
    over that mesh axis and idx.kmer_table holds only this chip's bucket-
    row shard — seed lookups route through the all_to_all query exchange
    (parallel/index_shard.sharded_kmer_lookup, BASELINE config 4); all
    other stages stay chip-local."""
    k = idx.k
    L = read_len
    MINI = idx.sampling == "minimizer"
    PARITY = idx.pos_mode == "parity"
    # parity packing loses <=1 bit of position and the vote key rounds the
    # diagonal to a multiple of 4, so the true window offset is in [0, 4]
    N_OFF = 5 if PARITY else 1
    if MINI:
        # expected winnowing density is 2/(w+1); headroom covers pick-rich
        # reads (site-tunable: each extra seed is one more HBM row gather
        # per read against the multi-GB human table)
        from ..params import get as _param
        headroom = float(_param("minimizer_seed_headroom"))
        S = max(8, int(np.ceil(headroom * 2 * (L - k + 1)
                               / (idx.minimizer_w + 1))))
        seed_offsets = None
    else:
        seed_offsets = np.arange(0, L - k + 1, SEED_STRIDE, dtype=np.int32)
        S = len(seed_offsets)
    H = MAX_HITS_PER_SEED * idx.kmer_table.probe_rows
    # parity packing rounds vote diagonals to multiples of 4, so one
    # locus's votes can SPLIT across two keys — parity mode keeps an
    # extra candidate slot (D=3 measured a 98.2% off-repeat recall there
    # vs >=99.5% at D=4; strand31 is unaffected)
    D = MAX_CANDIDATES + (1 if PARITY else 0)
    BIGK = jnp.uint32(0xFFFFFFFF)
    BIG = jnp.int32(2**31 - 1)
    n_sj = int(idx.sj_rows.shape[0])

    contig_len = jnp.uint32(2 * idx.sj_overhang)
    glen = jnp.uint32(idx.genome_len)
    fetch_win = make_window_fetch(idx, L + N_OFF - 1)

    def canonical_pos(idx, pos):
        """Map a text position to its genomic-equivalent absolute coordinate
        for distinct-locus counting: positions inside a junction contig's
        donor flank map to the same genomic coordinate as the direct genomic
        alignment, so an unspliced read hitting both is one locus."""
        if n_sj == 0:
            return pos
        pos = pos.astype(jnp.uint32)
        in_sj = pos >= glen
        j = jnp.where(in_sj, (pos - glen) // contig_len, 0).astype(jnp.int32)
        row = idx.sj_rows[j]                        # [..., 2] one gather
        off = jnp.where(in_sj, (pos - glen) % contig_len, 0)
        donor_start = row[..., 0] - jnp.uint32(idx.sj_overhang)
        canon_sj = jnp.where(off < idx.sj_overhang,
                             donor_start + off,
                             row[..., 1] + off - jnp.uint32(idx.sj_overhang))
        return jnp.where(in_sj, canon_sj, pos)

    @jax.jit
    def align_batch_impl(idx, rna, nmask):
        """rna uint8 [B, L], nmask bool [B, L] -> alignment dict. The index
        rides as a pytree argument so its arrays are runtime buffers, not
        compile-time constants."""
        B = rna.shape[0]
        rc = (3 - rna[:, ::-1]).astype(jnp.uint8)
        rc_mask = nmask[:, ::-1]

        # ---- canonical seed lookup: ONE row gather per seed ----
        kms = _rolling_kmers(rna, k)                 # [B, L-k+1]
        kvalid = _window_valid(nmask, k)
        if MINI:
            # winnowed seed picking: identical window-min rule to the
            # genome build, compacted to the earliest S picks via a
            # ONE-HOT MATMUL (one nonzero per output, so the einsum is an
            # exact select); values split into 16-bit halves stay exact
            # under HIGHEST-precision f32 accumulation
            n = kms.shape[1]
            kmr_all = revcomp_packed(kms, k)
            flip_all = kmr_all < kms
            canon_all = jnp.where(flip_all, kmr_all, kms)
            mh = canon_all * jnp.uint32(MINIMIZER_HASH)
            mh = jnp.where(kvalid, mh, BIGK)
            picked = _minimizer_picks(mh, idx.minimizer_w) & kvalid
            rank = jnp.cumsum(picked.astype(jnp.int32), axis=1) - 1
            T = (picked[:, :, None]
                 & (rank[:, :, None] == jnp.arange(S)[None, None, :])
                 ).astype(jnp.float32)               # [B, n, S] one-hot
            hp = jax.lax.Precision.HIGHEST
            sel = lambda x: jnp.einsum("bi,bis->bs", x, T, precision=hp)
            c_hi = sel((canon_all >> 16).astype(jnp.float32))
            c_lo = sel((canon_all & jnp.uint32(0xFFFF)).astype(jnp.float32))
            canon = (c_hi.astype(jnp.uint32) << 16) | c_lo.astype(jnp.uint32)
            flip = sel(flip_all.astype(jnp.float32)) > 0.5
            kv = jnp.sum(T, axis=1) > 0
            off_s = sel(jnp.arange(n, dtype=jnp.float32)[None, :]
                        ).astype(jnp.int32)          # [B, S] seed offsets
            off = off_s[:, :, None]
        else:
            km = kms[:, seed_offsets]                # [B, S]
            kv = kvalid[:, seed_offsets]
            kmr = revcomp_packed(km, k)
            flip = kmr < km
            canon = jnp.where(flip, kmr, km)
            off = seed_offsets[None, :, None]
        if shard_axis is not None:
            from ..parallel.index_shard import sharded_kmer_lookup
            hit, val, _ = sharded_kmer_lookup(idx.kmer_table, canon,
                                              shard_axis)
        else:
            hit, val = idx.kmer_table.lookup(canon)  # [B, S, H]
        hit = hit & kv[:, :, None]
        if PARITY:
            pos_h = val & jnp.uint32(0xFFFFFFFE)     # strand in parity bit
            sbit = (val & jnp.uint32(1)).astype(jnp.int32)
        else:
            pos_h = val & jnp.uint32(0x7FFFFFFF)
            sbit = (val >> jnp.uint32(31)).astype(jnp.int32)
        strand_h = sbit ^ flip[:, :, None].astype(jnp.int32)  # 0 fwd / 1 rc
        offterm = jnp.where(strand_h == 0, off, L - k - off).astype(jnp.uint32)
        ok = hit & (pos_h >= offterm)
        diag = pos_h - offterm                       # uint32, no wrap when ok
        if PARITY:
            # strand rides in bit 0 of the 4-rounded diagonal: full u32
            # coordinate space, true window start within [key, key+4]
            key = (diag & jnp.uint32(0xFFFFFFFC)) | strand_h.astype(jnp.uint32)
        else:
            key = diag | (strand_h.astype(jnp.uint32) << 31)
        key = jnp.where(ok, key, BIGK)               # [B, S, H]

        # ---- diagonal voting via pairwise equality counting ----
        # O(M^2) fused elementwise reductions instead of a [B, M]
        # comparator sort (O(M log^2 M) serialized passes): the equality
        # count + first-occurrence dedup vectorize perfectly and XLA
        # fuses them into the reduction (no [B, M, M] materializes)
        M = S * H
        flat = key.reshape(B, M)
        kvalid = flat != BIGK
        eq = flat[:, None, :] == flat[:, :, None]            # fused
        votes_all = jnp.sum((eq & kvalid[:, None, :]).astype(jnp.int32),
                            axis=2)
        tri = jnp.tril(jnp.ones((M, M), bool), -1)           # j < i
        earlier = jnp.any(eq & tri[None, :, :], axis=2)
        votes = jnp.where(kvalid & ~earlier, votes_all, 0)
        top_votes, top_i = jax.lax.top_k(votes, D)           # [B, D]
        cand_key = jnp.take_along_axis(flat, top_i, axis=1)  # [B, D]
        cand_ok = top_votes > 0
        if PARITY:
            cand_pos = cand_key & jnp.uint32(0xFFFFFFFC)     # uint32 coords
            cand_strand = (cand_key & jnp.uint32(1)).astype(jnp.int32)
        else:
            cand_pos = (cand_key & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
            cand_strand = (cand_key >> jnp.uint32(31)).astype(jnp.int32)

        # ---- ungapped local extension (Kadane via prefix scans) ----
        codes_d = jnp.where(cand_strand[:, :, None] == 1,
                            rc[:, None, :], rna[:, None, :])   # [B, D, L]
        mask_d = jnp.where(cand_strand[:, :, None] == 1,
                           rc_mask[:, None, :], nmask[:, None, :])
        win, wok = fetch_win(idx, jnp.where(cand_ok, cand_pos, 0))
        if N_OFF > 1:
            # parity mode: the true window start is cand_pos + o, o in
            # [0, N_OFF); pick o by net match count over a SUBSAMPLE of
            # read positions (stride 5 ~ 19 columns), then score once.
            # The right offset matches ~all sampled bases, a wrong offset
            # ~25% — the gap dwarfs sampling noise, and full-length
            # Kadane scoring below is unchanged.  5x fewer compares.
            sub = np.arange(0, L, 5, dtype=np.int32)
            wins = jnp.stack([win[..., o:o + L][..., sub]
                              for o in range(N_OFF)], 2)
            woks = jnp.stack([wok[..., o:o + L][..., sub]
                              for o in range(N_OFF)], 2)
            act5 = mask_d[:, :, None, sub] & woks         # [B, D, O, |sub|]
            m5 = (wins == codes_d[:, :, None, sub]) & act5
            net = (2 * jnp.sum(m5, -1, dtype=jnp.int32)
                   - jnp.sum(act5, -1, dtype=jnp.int32))
            best_off = jnp.argmax(net, axis=2).astype(jnp.int32)  # [B, D]
            # N_OFF-way select of static slices instead of a dynamic
            # gather along the minormost dim of [B, D, L]: elementwise
            # selects fuse into the scoring chain
            bo = jnp.broadcast_to(best_off[:, :, None], (B, D, L))
            win = jax.lax.select_n(bo, *[win[..., o:o + L]
                                         for o in range(N_OFF)])
            wok = jax.lax.select_n(bo, *[wok[..., o:o + L]
                                         for o in range(N_OFF)])
            cand_pos = cand_pos + best_off.astype(cand_pos.dtype)
        m = (win == codes_d) & wok & mask_d
        active = mask_d & wok
        contrib = jnp.where(active, jnp.where(m, 1, -1), 0).astype(jnp.int32)
        cs = jnp.cumsum(contrib, axis=2)
        pref = jnp.pad(cs, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]
        run_min = cummax(-pref, axis=2)   # = -min prefix
        best_at = cs + run_min                    # [B, D, L] best sum ending at i
        score = jnp.max(best_at, axis=2)          # [B, D]
        end_i = jnp.argmax(best_at, axis=2)       # inclusive end index
        li = jnp.arange(L, dtype=jnp.int32)[None, None, :]
        pref_masked = jnp.where(li <= end_i[:, :, None], pref, BIG)
        start_i = jnp.argmin(pref_masked, axis=2)
        aln_len = (end_i - start_i + 1).astype(jnp.int32)
        start_i = start_i.astype(jnp.int32)
        score = jnp.where(cand_ok, score, -BIG)

        # ---- distinct-locus counting + deterministic pick ----
        best_score = jnp.max(score, axis=1)                  # [B]
        is_best = score == best_score[:, None]
        canon = (canonical_pos(idx, jnp.where(cand_ok, cand_pos, 0))
                 .astype(jnp.uint32) + start_i.astype(jnp.uint32))
        if PARITY:
            # full-u32 coordinates: strand rides the parity bit (loci 1bp
            # apart collapsing is vanishingly rare and only perturbs MAPQ)
            ckey = (canon & jnp.uint32(0xFFFFFFFE)) | cand_strand.astype(jnp.uint32)
        else:
            ckey = (canon << 1) | cand_strand.astype(jnp.uint32)
        ckey_full = ckey
        ckey = jnp.where(is_best & (score > -BIG), ckey_full, BIGK)
        ckey_sorted = jnp.sort(ckey, axis=1)
        distinct = jnp.concatenate(
            [jnp.ones((B, 1), bool),
             ckey_sorted[:, 1:] != ckey_sorted[:, :-1]], axis=1)
        n_best = jnp.sum(
            jnp.where(distinct & (ckey_sorted != BIGK), 1, 0), axis=1)

        # ---- candidate-cap honesty (repeat-rich genomes) ----
        # D caps the EXAMINED loci, but the vote table saw every seeded
        # diagonal. If every distinct examined locus ties at the best
        # score AND more vote-positive diagonals exist than we examined,
        # unexamined loci could tie too: report n_best = D+1 (MAPQ 0, the
        # STAR >4-loci bucket) and flag the read so gene promotion skips
        # it. Slightly conservative (a 1-vote noise diagonal can demote a
        # true D-locus tie from MAPQ 1 to 0); never optimistic.
        n_diags = jnp.sum((votes > 0).astype(jnp.int32), axis=1)
        ckey_any = jnp.where(cand_ok & (score > -BIG), ckey_full, BIGK)
        any_sorted = jnp.sort(ckey_any, axis=1)
        distinct_any = jnp.concatenate(
            [jnp.ones((B, 1), bool),
             any_sorted[:, 1:] != any_sorted[:, :-1]], axis=1)
        n_exam = jnp.sum(
            jnp.where(distinct_any & (any_sorted != BIGK), 1, 0), axis=1)
        saturated = (n_diags > D) & (n_best >= n_exam) & (n_best >= 1)
        # saturated n_best follows the vote-table diagonal count (clipped
        # to the STAR >4-loci bucket) so the 3-4-loci vs >4 MAPQ boundary
        # stays right even when D < 4 examined candidates
        n_best = jnp.where(saturated,
                           jnp.clip(n_diags, D + 1, 5), n_best)

        # deterministic pick among ties: smallest (canon, strand) — stable
        pick = jnp.argmin(ckey, axis=1)
        take = lambda a: jnp.take_along_axis(a, pick[:, None], axis=1)[:, 0]

        best_pos = take(cand_pos)
        best_strand = take(cand_strand)
        # ALL distinct best-scoring loci in canonical order (multimapper
        # gene promotion considers every alignment of the read,
        # read.rs:117-149): sort the locus keys; duplicates mask off
        order_l = jnp.argsort(ckey, axis=1)                   # [B, D]
        ckey_s = jnp.take_along_axis(ckey, order_l, axis=1)
        loci_ok = jnp.concatenate(
            [ckey_s[:, :1] != BIGK,
             (ckey_s[:, 1:] != ckey_s[:, :-1]) & (ckey_s[:, 1:] != BIGK)],
            axis=1)
        takeL = lambda a: jnp.take_along_axis(a, order_l, axis=1)
        out = dict(
            pos=best_pos, strand=best_strand, score=best_score,
            aln_start=take(start_i), aln_len=take(aln_len), n_best=n_best,
            loci_pos=takeL(cand_pos), loci_strand=takeL(cand_strand),
            loci_start=takeL(start_i), loci_len=takeL(aln_len),
            loci_ok=loci_ok, saturated=saturated,
        )

        if novel_sj:
            # ---- novel splice junction discovery (COMPACTED) ----
            # A spliced read over an UNANNOTATED junction seeds TWO
            # same-strand candidate diagonals whose offset is the intron
            # length. Split score at read position x reuses the per-
            # candidate prefix machinery already computed:
            #   T(i,j,x) = best_end_i(x) + best_start_j(x+1)
            # i.e. Kadane best-sum ending at x on the left window plus
            # best-sum starting at x+1 on the right window. Only SUSPECTS
            # run it: reads whose best unspliced score cannot explain the
            # read AND that have >=2 candidate loci — compacted to B/4
            # like SW rescue, so the full-length-mappable bulk pays ~zero.
            CJ = min(B, max(B // RESCUE_CAP_FRAC, 64))
            vlen = jnp.sum(nmask.astype(jnp.int32), axis=1)
            n_cand = jnp.sum(cand_ok.astype(jnp.int32), axis=1)
            need_sj = ((best_score < vlen - SJ_MARGIN) & (n_cand >= 2)
                       & (best_score > -BIG))
            selj = jnp.nonzero(need_sj, size=CJ, fill_value=B)[0]
            sjc = jnp.minimum(selj, B - 1)
            cs_j = cs[sjc]                               # [C, D, L]
            pref_j = pref[sjc]
            best_at_j = best_at[sjc]
            cand_pos_j = cand_pos[sjc]
            cand_strand_j = cand_strand[sjc]
            cand_ok_j = cand_ok[sjc]
            best_score_j = best_score[sjc]

            rcm = cummax(cs_j, axis=2, reverse=True)
            best_start_at = rcm - pref_j                 # [C, D, L]
            bs_shift = jnp.concatenate(
                [best_start_at[:, :, 1:],
                 jnp.full((CJ, D, 1), -BIG, jnp.int32)], axis=2)
            posu = cand_pos_j.astype(jnp.uint32)
            in_gen = posu < glen                         # contigs excluded
            intron = posu[:, None, :] - posu[:, :, None]  # [C, i, j]
            pair_ok = (cand_ok_j[:, :, None] & cand_ok_j[:, None, :]
                       & (cand_strand_j[:, :, None] == cand_strand_j[:, None, :])
                       & in_gen[:, :, None] & in_gen[:, None, :]
                       & (posu[:, None, :] > posu[:, :, None])
                       & (intron >= jnp.uint32(SJ_MIN_INTRON))
                       & (intron <= jnp.uint32(SJ_MAX_INTRON)))
            seg_r_ok = bs_shift >= SJ_MIN_SEG
            ps, pxs = [], []
            for i in range(D):                           # unrolled: D small
                t = jnp.where((best_at_j[:, i:i + 1, :] >= SJ_MIN_SEG)
                              & seg_r_ok,
                              best_at_j[:, i:i + 1, :] + bs_shift, -BIG)
                ps.append(jnp.max(t, axis=2))            # [C, D]
                pxs.append(jnp.argmax(t, axis=2).astype(jnp.int32))
            pscore = jnp.where(pair_ok, jnp.stack(ps, 1), -BIG)  # [C, i, j]
            px = jnp.stack(pxs, 1)
            bestp = jnp.argmax(pscore.reshape(CJ, D * D), axis=1)
            takep = lambda a: jnp.take_along_axis(
                a.reshape(CJ, D * D), bestp[:, None], 1)[:, 0]
            sp_score = takep(pscore)
            sx = takep(px)                               # split read index
            bi = (bestp // D).astype(jnp.int32)
            bj = (bestp % D).astype(jnp.int32)
            takec = lambda a, w: jnp.take_along_axis(a, w[:, None], 1)[:, 0]
            taker = lambda a, w: jnp.take_along_axis(
                a, w[:, None, None], 1)[:, 0, :]
            pos_l = takec(posu, bi)
            pos_r = takec(posu, bj)
            sj_strand = takec(cand_strand_j, bi)
            ba_l = taker(best_at_j, bi)                  # [C, L]
            bs_r = taker(bs_shift, bj)
            pref_l = taker(pref_j, bi)
            cs_r = taker(cs_j, bj)

            # canonical-motif plateau shift (STAR junction shifting): among
            # equal-score splits near x*, prefer a GT..AG / CT..AC intron
            fetch8 = make_window_fetch(idx, 8)
            sxu = sx.astype(jnp.uint32)
            two = jnp.uint32(2)
            dstart = jnp.where(pos_l + sxu >= two, pos_l + sxu - two,
                               jnp.uint32(0))            # donor_end - 3
            four = jnp.uint32(4)
            astart = jnp.where(pos_r + sxu >= four, pos_r + sxu - four,
                               jnp.uint32(0))            # acc_start - 5
            dwin, dok8 = fetch8(idx, dstart)
            awin, aok8 = fetch8(idx, astart)
            sh_np = np.array([0, -1, 1, -2, 2, -3, 3], np.int32)  # priority
            shifts = jnp.asarray(sh_np)
            xi = sx[:, None] + shifts[None, :]
            inb = (xi >= 0) & (xi < L - 1)
            xic = jnp.clip(xi, 0, L - 1)
            t_eq = (jnp.take_along_axis(ba_l, xic, 1)
                    + jnp.take_along_axis(bs_r, xic, 1)) == sp_score[:, None]
            d0, d1 = dwin[:, sh_np + 3], dwin[:, sh_np + 4]
            a0, a1 = awin[:, sh_np + 3], awin[:, sh_np + 4]
            mok = (dok8[:, sh_np + 3] & dok8[:, sh_np + 4]
                   & aok8[:, sh_np + 3] & aok8[:, sh_np + 4])
            # A=0 C=1 G=2 T=3: GT..AG or CT..AC (either gene strand)
            canon7 = (((d0 == 2) & (d1 == 3) & (a0 == 0) & (a1 == 2))
                      | ((d0 == 1) & (d1 == 3) & (a0 == 0) & (a1 == 1)))
            canon7 = canon7 & t_eq & inb & mok
            has_canon = canon7.any(axis=1)
            s_sel = jnp.where(has_canon,
                              shifts[jnp.argmax(canon7, axis=1)], 0)
            xs = sx + s_sel
            sp_final = sp_score - jnp.where(has_canon, 0, SJ_NONCANON_PEN)
            win_c = (sp_final > best_score_j + SJ_MARGIN) & (sp_score > 0) \
                & (selj < B)

            li1 = jnp.arange(L, dtype=jnp.int32)[None, :]
            pm = jnp.where(li1 <= xs[:, None], pref_l, BIG)
            lstart = jnp.argmin(pm, axis=1).astype(jnp.int32)
            cm = jnp.where(li1 > xs[:, None], cs_r, -BIG)
            rend = jnp.argmax(cm, axis=1).astype(jnp.int32)
            xs1 = (xs + 1).astype(jnp.uint32)
            pdt = out["pos"].dtype

            def scat(init, vals):
                return init.at[selj].set(jnp.where(win_c, vals, init[sjc]),
                                         mode="drop")

            win_sj = jnp.zeros((B,), bool).at[selj].set(win_c, mode="drop")
            out["novel_sj"] = win_sj
            out["sj_donor"] = scat(jnp.zeros((B,), pdt),
                                   (pos_l + xs1).astype(pdt))
            out["sj_acceptor"] = scat(jnp.zeros((B,), pdt),
                                      (pos_r + xs1).astype(pdt))
            out["sj_left_len"] = scat(jnp.zeros((B,), jnp.int32),
                                      xs - lstart + 1)
            out["sj_right_len"] = scat(jnp.zeros((B,), jnp.int32), rend - xs)
            out["sj_score"] = scat(jnp.full((B,), -BIG, jnp.int32), sp_final)
            out["pos"] = scat(out["pos"], pos_l.astype(pdt))
            out["strand"] = scat(out["strand"], sj_strand)
            out["aln_start"] = scat(out["aln_start"], lstart)
            out["aln_len"] = scat(out["aln_len"], xs - lstart + 1)
            n_best = jnp.where(win_sj, 1, n_best)
            out["n_best"] = n_best
            best_score = scat(best_score, sp_final)
            out["score"] = best_score

        if sw_rescue:
            # gapped rescue ONLY for reads whose ungapped score missed the
            # floor but that do have a candidate locus (indel suspects) —
            # compacted to a fixed capacity, scattered back
            from .sw import BAND, rescue_sw
            C = max(B // RESCUE_CAP_FRAC, 1)
            # indel suspects: the ungapped score can't explain the read
            # (mismatch-only reads score ~valid_len - 2*errors and their
            # gapped score equals the ungapped one — nothing to refine)
            valid_len = jnp.sum(nmask.astype(jnp.int32), axis=1)
            need = (best_score < valid_len - RESCUE_MARGIN) & (best_score > -BIG)
            sel = jnp.nonzero(need, size=C, fill_value=B)[0]   # B = OOB drop
            codes_b = jnp.where(best_strand[:, None] == 1, rc, rna)[
                jnp.minimum(sel, B - 1)]
            mask_b = jnp.where(best_strand[:, None] == 1, rc_mask, nmask)[
                jnp.minimum(sel, B - 1)]
            half = jnp.asarray(BAND // 2, best_pos.dtype)
            win_start = jnp.where(best_pos > half, best_pos - half,
                                  jnp.zeros((), best_pos.dtype))[
                jnp.minimum(sel, B - 1)]
            fetch_sw = make_window_fetch(idx, L + BAND)
            win_s, wok_s = fetch_sw(idx, win_start)
            sw_score_c, _, _ = rescue_sw(codes_b, mask_b, win_s, wok_s)
            sw_score = jnp.zeros((B,), jnp.int32).at[sel].set(
                sw_score_c, mode="drop")
            eff_score = jnp.maximum(best_score, sw_score)
            out["sw_score"] = sw_score
        else:
            eff_score = best_score

        mapped = (eff_score >= score_min) & (n_best >= 1)
        mapq = jnp.select(
            [n_best <= 1, n_best == 2, n_best <= 4],
            [jnp.int32(255), jnp.int32(3), jnp.int32(1)], jnp.int32(0))
        out["mapq"] = jnp.where(mapped, mapq, 0)
        out["mapped"] = mapped
        return out

    if not bind:
        # unbound form: caller passes the index per call, keeping it an
        # argument (not a constant) of any OUTER jit that inlines this
        return align_batch_impl

    def align_batch(rna, nmask):
        return align_batch_impl(idx, rna, nmask)

    return align_batch
