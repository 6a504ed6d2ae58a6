"""Gene annotation of alignments: device-friendly re-design of the
reference's TranscriptAnnotator (lib/rust/tx_annotation/src/transcript.rs:268,
annotate_alignment :311-434, align_to_transcript :436-571).

Semantics matched:
  * per-transcript region: EXONIC if a splice segment of the read has >= 50%
    overlap with some exon (region_min_overlap, transcript.rs is_read_exonic);
    INTRONIC if not exonic but contained in the transcript span; else
    intergenic. Read-level region = max-priority across transcripts
    (exonic > intronic > intergenic).
  * sense/antisense: chemistry_strandedness '+': antisense iff read strand !=
    transcript strand; '-': antisense iff equal (transcript.rs:478-482).
  * counted genes = distinct genes with sense exonic/intronic alignments
    (include-introns mode, the reference default since CR7); a read is
    confidently mapped to the transcriptome when MAPQ==255 and exactly one
    distinct gene (read.rs:129).

Device formulation, driven by the row-gather cost (a random row fetch
costs about the same whatever its width): no binary searches — a
precomputed 128-base GRID maps a read's end coordinate straight to its
window position in the exon table (1 small gather), and the window itself
is TWO 128-byte row fetches of 8 packed exons each (start/end/meta columnar
per row). Interval tables are deduplicated (identical exon spans across
isoforms collapse), so 16 windowed exons cover loci that the per-transcript
table needed 50+ rows for. Junction-contig alignments take one row from a
per-junction (gene, strand) table.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_dataclass

from ..constants import REGION_MIN_OVERLAP
from ..io.gtf import Transcriptome
from .index import GenomeIndex

GRID_SHIFT = 7       # 128-base annotation grid bins
ROW_E = 16           # intervals per packed table row (256-byte rows)

REGION_EXONIC = 0
REGION_INTRONIC = 1
REGION_INTERGENIC = 2

GENE_NONE = -1
GENE_MULTI = -2

_PAD_START = np.uint32(0xFFFFFFFF)  # never < any query end


def _pack_interval_rows(start, end, gene, strand, is_tx):
    """Sorted COMBINED interval table (exons + transcript spans) ->
    [R+2, 3*ROW_E] uint32 rows: start*16 | end*16 | meta*16 with
    meta = gene | is_tx<<29 | strand<<30. One 192-byte row gather surfaces
    16 intervals; exon and transcript-span probes share the SAME fetch
    (halves annotation row gathers vs separate tables). Coordinates are
    FULL uint32 (parity-safe for >2Gb text). Pad entries: start=0xFFFFFFFF
    (never < e), end=0 (never > s)."""
    n = len(start)
    R = (n + ROW_E - 1) // ROW_E + 2
    rows = np.zeros((R, 3 * ROW_E), np.uint32)
    flat_s = np.full(R * ROW_E, _PAD_START, np.uint32)
    flat_e = np.zeros(R * ROW_E, np.uint32)
    flat_m = np.zeros(R * ROW_E, np.int32)
    flat_s[:n] = start.astype(np.uint32)
    flat_e[:n] = end.astype(np.uint32)
    flat_m[:n] = (gene | (is_tx.astype(np.int32) << 29)
                  | (strand.astype(np.int32) << 30))
    rows[:, :ROW_E] = flat_s.reshape(R, ROW_E)
    rows[:, ROW_E:2 * ROW_E] = flat_e.reshape(R, ROW_E)
    rows[:, 2 * ROW_E:3 * ROW_E] = flat_m.reshape(R, ROW_E).astype(np.uint32)
    return rows


def _build_grid(starts: np.ndarray, text_span: int) -> np.ndarray:
    """grid[g] = count of intervals with start < (g+1)*BIN — an upper bound
    of the true window position for any query end inside bin g."""
    gb = (text_span >> GRID_SHIFT) + 2
    bin_ends = (np.arange(gb, dtype=np.int64) + 1) << GRID_SHIFT
    return np.searchsorted(starts, bin_ends, side="left").astype(np.int32)


@register_dataclass
@dataclass(frozen=True)
class AnnotationIndex:
    """Device arrays for annotation (absolute text coordinates).
    A jax pytree: arrays pass through jit as arguments (n_genes static)."""

    iv_rows: jnp.ndarray    # uint32 [R+2, 48] packed dedup'd intervals
    iv_grid: jnp.ndarray    # int32 [GB]
    sj_rows: jnp.ndarray    # int32 [J, 2]: (gene or GENE_MULTI, strand)
    n_genes: int = field(metadata=dict(static=True), default=0)

    @staticmethod
    def build(txome: Transcriptome, gi: GenomeIndex) -> "AnnotationIndex":
        cidx = {n: i for i, n in enumerate(gi.chrom_names)}
        exs, exe, exg, exstr = [], [], [], []
        txs, txe, txg, txstr = [], [], [], []
        for t in txome.transcripts:
            if t.chrom not in cidx:
                continue
            c0 = int(gi.chrom_starts[cidx[t.chrom]])
            strand = 0 if t.strand == "+" else 1
            txs.append(c0 + t.start)
            txe.append(c0 + t.end)
            txg.append(t.gene_index)
            txstr.append(strand)
            for (s, e) in t.exons:
                exs.append(c0 + s)
                exe.append(c0 + e)
                exg.append(t.gene_index)
                exstr.append(strand)

        # one combined table: exons (is_tx=0) + transcript spans (is_tx=1)
        all_s = np.asarray(exs + txs, np.int64)
        all_e = np.asarray(exe + txe, np.int64)
        all_g = np.asarray(exg + txg, np.int64)
        all_st = np.asarray(exstr + txstr, np.int64)
        all_tx = np.concatenate([np.zeros(len(exs), np.int64),
                                 np.ones(len(txs), np.int64)])
        if len(all_s):
            arr = np.unique(np.stack(
                [all_s, all_e, all_g, all_st, all_tx], axis=1), axis=0)
            arr = arr[np.argsort(arr[:, 0], kind="stable")]
        else:
            arr = np.zeros((0, 5), np.int64)
        iv_start = arr[:, 0].astype(np.uint32)
        iv_end = arr[:, 1].astype(np.uint32)
        iv_gene = arr[:, 2].astype(np.int32)
        iv_strand = arr[:, 3].astype(np.int32)
        iv_tx = arr[:, 4].astype(np.int32)
        span = int(gi.genome_len)

        # junction annotation: distinct genes/strands of transcripts sharing it
        j_gene, j_strand = [], []
        txl = txome.transcripts
        by_key = dict(sorted(txome.junctions().items()))
        for i in range(gi.n_junctions):
            key = (gi.chrom_names[gi.sj_chrom[i]],
                   int(gi.sj_donor_end[i] - gi.chrom_starts[gi.sj_chrom[i]]),
                   int(gi.sj_acceptor_start[i] - gi.chrom_starts[gi.sj_chrom[i]]))
            tids = by_key.get(key, [])
            genes = {txl[t].gene_index for t in tids}
            strands = {txl[t].strand for t in tids}
            j_gene.append(genes.pop() if len(genes) == 1 else GENE_MULTI)
            j_strand.append(0 if strands == {"+"} else (1 if strands == {"-"} else 0))
        sj = np.stack([np.asarray(j_gene, np.int32),
                       np.asarray(j_strand, np.int32)], axis=1) \
            if j_gene else np.zeros((0, 2), np.int32)

        return AnnotationIndex(
            iv_rows=jnp.asarray(_pack_interval_rows(
                iv_start, iv_end, iv_gene, iv_strand, iv_tx)),
            iv_grid=jnp.asarray(_build_grid(iv_start, span)),
            sj_rows=jnp.asarray(sj),
            n_genes=len(txome.genes),
        )


def _window_fetch(rows, grid, s, e):
    """Query intervals [s,e): returns (start, end, gene, strand, is_tx,
    valid) each [B, 2*ROW_E] — the last <=32 table intervals with start < e
    that overlap [s,e). Three row gathers total (grid + two packed rows)."""
    GB = grid.shape[0]
    hi = grid[jnp.clip((e >> GRID_SHIFT).astype(jnp.int32), 0, GB - 1)]
    r = hi >> 4                                         # ROW_E = 16
    ra = rows[jnp.maximum(r - 1, 0)]                    # [B, 48]
    rb = rows[r]
    # coordinates stay uint32 (full 4Gb space); meta reinterprets as int32
    starts = jnp.concatenate([ra[:, :ROW_E], rb[:, :ROW_E]], -1)
    ends = jnp.concatenate(
        [ra[:, ROW_E:2 * ROW_E], rb[:, ROW_E:2 * ROW_E]], -1)
    meta = jnp.concatenate(
        [ra[:, 2 * ROW_E:3 * ROW_E], rb[:, 2 * ROW_E:3 * ROW_E]], -1).astype(jnp.int32)
    j = jnp.arange(2 * ROW_E, dtype=jnp.int32)[None, :]
    eidx = (r[:, None] - 1) * ROW_E + j                 # global interval idx
    ok = (eidx >= 0) & (eidx < hi[:, None]) \
        & (starts < e[:, None]) & (ends > s[:, None])
    gene = meta & ((1 << 29) - 1)
    is_tx = (meta >> 29) & 1
    strand = (meta >> 30) & 1
    return starts, ends, gene, strand, is_tx, ok


def make_annotator(ann: AnnotationIndex, gi_genome_len: int, sj_overhang: int,
                   chemistry_strandedness: str = "+", bind: bool = True):
    """Build jitted annotate(pos, aln_len, strand, mapq, mapped) -> dict."""
    contig_len = 2 * sj_overhang
    n_sj = int(ann.sj_rows.shape[0])
    flip = 0 if chemistry_strandedness == "+" else 1
    W = 2 * ROW_E

    @jax.jit
    def annotate_impl(ann, pos, aln_len, strand, mapq, mapped):
        B = pos.shape[0]
        s = pos.astype(jnp.uint32)             # full u32 coordinate space
        e = s + aln_len.astype(jnp.uint32)
        alen = aln_len

        # ---- genomic alignments: ONE combined interval window probe ----
        iv_s, iv_e, iv_g, iv_str, iv_tx, iov = _window_fetch(
            ann.iv_rows, ann.iv_grid, s, e)
        is_ex = iov & (iv_tx == 0)
        is_txs = iov & (iv_tx == 1)
        ov_len = (jnp.minimum(iv_e, e[:, None])
                  - jnp.maximum(iv_s, s[:, None]))
        exonic_hit = is_ex & (ov_len.astype(jnp.float32)
                              >= REGION_MIN_OVERLAP * alen[:, None].astype(jnp.float32))
        # sense: antisense iff (read_strand != tx_strand) xor chem'-'
        iv_sense = (iv_str == strand[:, None]) ^ (flip == 1)
        exonic_sense = exonic_hit & iv_sense
        any_exonic = exonic_hit.any(axis=1)
        ex_genes = jnp.where(exonic_sense, iv_g, GENE_NONE)

        # intronic requires full containment in the transcript span
        # (transcript.rs:462-463 get_overlap >= 1.0)
        intronic_hit = is_txs & (iv_s <= s[:, None]) & (iv_e >= e[:, None])
        any_intronic = intronic_hit.any(axis=1)
        in_genes = jnp.where(intronic_hit & iv_sense, iv_g, GENE_NONE)

        # Gene priority (transcript.rs:376-404): transcriptomic (exonic) sense
        # genes win; intronic sense genes count only when no exonic-sense hit
        # exists (include-introns mode).
        any_ex_sense = (ex_genes != GENE_NONE).any(axis=1)
        genes_all = jnp.where(
            any_ex_sense[:, None],
            jnp.concatenate([ex_genes,
                             jnp.full_like(in_genes, GENE_NONE)], axis=1),
            jnp.concatenate([jnp.full_like(ex_genes, GENE_NONE), in_genes], axis=1))
        gs = jnp.sort(genes_all, axis=1)
        is_gene = gs != GENE_NONE
        distinct = jnp.concatenate(
            [jnp.ones((B, 1), bool), gs[:, 1:] != gs[:, :-1]], axis=1) & is_gene
        n_genes = distinct.sum(axis=1)
        first_gene = jnp.max(jnp.where(is_gene, gs, GENE_NONE), axis=1)
        gene_genomic = jnp.where(
            n_genes == 1, first_gene, jnp.where(n_genes > 1, GENE_MULTI, GENE_NONE))
        region_genomic = jnp.where(
            any_exonic, REGION_EXONIC,
            jnp.where(any_intronic, REGION_INTRONIC, REGION_INTERGENIC))
        # antisense flag: no sense gene but an antisense one exists
        any_sense = n_genes > 0
        anti_ex = (exonic_hit & ~iv_sense).any(axis=1)
        antisense_genomic = ~any_sense & anti_ex

        # ---- junction-contig alignments: one row gather ----
        glen = jnp.uint32(gi_genome_len)
        in_sj = s >= glen
        if n_sj > 0:
            j = jnp.clip(jnp.where(in_sj, (s - glen) // jnp.uint32(contig_len),
                                   0).astype(jnp.int32), 0, n_sj - 1)
            sjr = ann.sj_rows[j]                          # [B, 2]
            sjg = sjr[:, 0]
            sj_sense = (sjr[:, 1] == strand) ^ (flip == 1)
            gene_sj = jnp.where(sj_sense & (sjg >= 0), sjg, GENE_NONE)
            anti_sj = ~sj_sense
        else:
            gene_sj = jnp.full(B, GENE_NONE, jnp.int32)
            anti_sj = jnp.zeros(B, bool)

        gene = jnp.where(in_sj, gene_sj, gene_genomic)
        region = jnp.where(in_sj, REGION_EXONIC, region_genomic)
        antisense = jnp.where(in_sj, anti_sj, antisense_genomic)

        # ---- per-read gene LISTS for the BAM TX/AN tags ----
        # top-K distinct sense genes (the TX tag's gene set) and distinct
        # antisense genes (AN; transcript.rs:73-99).  K=4 covers all but
        # pathological overlap stacks.
        KG = 4
        sense_vals = jnp.where(distinct, gs, GENE_NONE)
        sense_top, _ = jax.lax.top_k(sense_vals, KG)         # [B, KG] desc
        anti_hits = (exonic_hit | intronic_hit) & ~iv_sense
        anti_all = jnp.where(anti_hits, iv_g, GENE_NONE)
        ga = jnp.sort(anti_all, axis=1)
        anti_distinct = jnp.concatenate(
            [jnp.ones((B, 1), bool), ga[:, 1:] != ga[:, :-1]],
            axis=1) & (ga != GENE_NONE)
        anti_top, _ = jax.lax.top_k(
            jnp.where(anti_distinct, ga, GENE_NONE), KG)
        # junction-contig reads carry at most one gene either way
        sj_col = jnp.where(in_sj & (gene >= 0), gene, GENE_NONE)
        if n_sj > 0:
            sj_anti_col = jnp.where(in_sj & anti_sj & (sjg >= 0), sjg,
                                    GENE_NONE)
        else:
            sj_anti_col = jnp.full(B, GENE_NONE, jnp.int32)
        pad = jnp.full((B, KG - 1), GENE_NONE, jnp.int32)
        sense_top = jnp.where(in_sj[:, None],
                              jnp.concatenate([sj_col[:, None], pad], 1),
                              sense_top)
        anti_top = jnp.where(in_sj[:, None],
                             jnp.concatenate([sj_anti_col[:, None], pad], 1),
                             anti_top)

        conf_mapped = mapped & (mapq == 255) & (gene >= 0)
        return dict(gene=gene, region=region, antisense=antisense,
                    conf_mapped=conf_mapped,
                    gene_list=sense_top, anti_list=anti_top)

    if not bind:
        return annotate_impl

    def annotate(pos, aln_len, strand, mapq, mapped):
        return annotate_impl(ann, pos, aln_len, strand, mapq, mapped)

    return annotate
