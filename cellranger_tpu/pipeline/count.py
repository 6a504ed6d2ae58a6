"""The `count` pipeline: FASTQ -> filtered feature x barcode matrix.

In-process device re-design of the reference's counting pipeline
(mro/rna/_slfe_matrix_computer.mro:25 + _basic_sc_rna_counter.mro:12).
Instead of Martian stages communicating via shardio files on disk, the run
is two streaming passes of fixed-shape device batches plus one global
device dedup:

  pass 1 (== MAKE_SHARD, make_shard.rs:169): extract + whitelist-count the
      valid barcodes (the correction prior);
  pass 2 (== BARCODE_CORRECTION + ALIGN_AND_COUNT): one fused jit step per
      batch — posterior barcode correction, seed/extend alignment,
      annotation — emitting per-read molecule keys;
  dedup (== the per-barcode DupMarker, mark_dups.rs): one global sorted
      dedup over all conf-mapped reads;
  outputs: raw/filtered matrix h5 + MEX, cell calls, metrics JSON.

Multi-chip: batches shard over the mesh data axis; the whitelist count
histogram and molecule table merge with psum/all-gather (see parallel/).
"""

from __future__ import annotations

import functools
import json
import os
import queue as _queue
import threading
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..align.aligner import DeviceIndex, make_aligner
from ..align.annotate import AnnotationIndex, make_annotator, REGION_EXONIC, \
    REGION_INTRONIC, REGION_INTERGENIC, GENE_MULTI, GENE_NONE
from ..align.index import GenomeIndex
from ..analysis import cell_calling
from ..io.chemistry import Chemistry, get_chemistry
from ..io.fastq import ReadBatch, batches_from_fastqs, find_fastqs
from ..io.matrix_io import CountMatrix, FeatureReference
from ..io.molecule_info import save_molecule_info
from ..io.reference import ReferencePackage
from ..io.whitelist import Whitelist
from ..ops import barcode as bcops
from ..ops.bucket_table import BucketTable
from ..ops.lookup import SortedTable
from ..ops import encode


@dataclass
class LibraryDef:
    """One sequencing library of a run (the reference's LibrariesCsv row,
    multi/src/config/mod.rs:1237)."""

    fastq_pairs: list[tuple[str, str | None]]
    library_type: str = "Gene Expression"  # or "Antibody Capture", ...


@dataclass
class CountConfig:
    fastq_pairs: list[tuple[str, str | None]]
    reference_path: str | None = None
    whitelist_path: str | None = None
    probe_set_csv: str | None = None   # RTL runs align to probes, not genome
    feature_ref_csv: str | None = None
    libraries: list[LibraryDef] | None = None  # defaults to fastq_pairs as GEX
    chemistry: str = "SC3Pv3"
    read_len: int = 91
    batch_size: int = 8192
    recovered_cells: int | None = None
    force_cells: int | None = None
    # cell calling mode: "auto" = ordmag + EmptyDrops; "gradient" = the
    # targeted-panel steepest-gradient caller (cell_calling_helpers.py:992)
    cell_calling_mode: str = "auto"
    # post-call filters (filter_barcodes/__init__.py:553-575)
    max_mito_percent: float = 100.0   # cr_cell.MAX_MITO_PCT default
    global_minimum_umis: int = 0      # cr_cell.MIN_GLOBAL_UMIS default
    sample_id: str = "sample"
    gem_group: int = 1
    write_bam: bool = False
    secondary_analysis: bool = True
    # RTL multiplexing (MFRP): probe barcode whitelist CSV (id,sequence);
    # molecules land in the (gel-bead x probe-bc) product barcode space
    probe_barcode_csv: str | None = None
    # pipestance-style resume (SURVEY §5.4): persist the deduplicated
    # molecule table under <out_dir>/_checkpoint/ and skip the FASTQ
    # passes on rerun with unchanged inputs (BAM emission, which needs
    # per-read state, reruns only on a fresh pass)
    checkpoint: bool = True
    # BASELINE config 4: shard the genome kmer table across the mesh
    # (each chip owns a bucket-row range; seed queries exchange via
    # all_to_all — parallel/index_shard.py).  Needs a mesh; results are
    # identical to the replicated-index run.  Use when the index exceeds
    # one chip's HBM (multi-species / custom references).
    shard_index: bool = False


@dataclass
class CountMetrics:
    total_reads: int = 0
    valid_barcode_reads: int = 0
    corrected_barcode_reads: int = 0
    valid_umi_reads: int = 0
    mapped_reads: int = 0
    conf_mapped_reads: int = 0
    exonic_reads: int = 0
    intronic_reads: int = 0
    intergenic_reads: int = 0
    antisense_reads: int = 0
    usable_reads: int = 0  # valid bc + valid umi + conf mapped
    total_molecules: int = 0
    q30_bc_bases: int = 0
    bc_bases: int = 0
    q30_umi_bases: int = 0
    umi_bases: int = 0
    q30_rna_bases: int = 0
    rna_bases: int = 0
    # reads whose invalid barcode exceeded the per-batch correction
    # capacity on the first pass (zero after the host retry loop; kept for
    # observability of how often the retry fired)
    correction_capacity_overflow: int = 0
    # batches whose correction overflow triggered the full-width host retry
    correction_retries: int = 0
    # reads whose cDNA matched the TSO adapter (score >= 20, aligner.rs:180)
    tso_reads: int = 0
    # reads with a trimmed polyA tail
    polya_trimmed_reads: int = 0
    # paired-end: pairs with a mapped mate that were not proper
    # (discordant strand/distance or one-sided) -> whole pair unmapped
    improper_pair_reads: int = 0
    # multimapped reads whose loci pairs overflowed the promotion capacity
    # (never considered for gene promotion; silent in r1, counted now)
    promote_overflow: int = 0
    # novel-SJ rows beyond the per-batch device append capacity
    # (accumulate mode; junction tallies only, molecules are never capped)
    sj_capacity_overflow: int = 0

    def to_dict(self, extra: dict | None = None) -> dict:
        d = dict(self.__dict__)
        t = max(self.total_reads, 1)
        d["valid_barcode_frac"] = self.valid_barcode_reads / t
        d["valid_umi_frac"] = self.valid_umi_reads / t
        d["mapped_frac"] = self.mapped_reads / t
        d["conf_mapped_frac"] = self.conf_mapped_reads / t
        d["antisense_frac"] = self.antisense_reads / t
        d["sequencing_saturation"] = (
            1.0 - self.total_molecules / self.usable_reads
            if self.usable_reads else 0.0)
        d["q30_barcode_frac"] = self.q30_bc_bases / max(self.bc_bases, 1)
        d["q30_umi_frac"] = self.q30_umi_bases / max(self.umi_bases, 1)
        d["q30_rna_frac"] = self.q30_rna_bases / max(self.rna_bases, 1)
        d["tso_frac"] = self.tso_reads / t
        if extra:
            d.update(extra)
        return d


MAX_INSERT = 2000      # max genomic span of a proper read pair (fragment
                       # sizes are <1kb; generous bound like STAR's window)

# the spill/dedup gene column carries the LIBRARY index in its high bits so
# molecules stay distinct per library (the reference processes per-library
# chunks, molecule_counter.py:90-104 tracks a real library table); stripped
# back out after dedup.  24 bits cover any feature reference; 8 bits of
# library index.
LIB_SHIFT = 24
LIB_MASK = np.uint32((1 << LIB_SHIFT) - 1)

# ---- packed step IO (round 3: ONE transfer each way per batch) ----
#
# INPUT: one [B, W] uint32 plane: one host->device transfer per batch
# instead of 8-10 separate arrays (~200B/read).  Barcode membership +
# posterior correction run on the HOST (vectorized searchsorted +
# 48-candidate probe over the few % invalid reads,
# ops.barcode.host_resolve_barcodes), so the batch ships a final bc_idx
# and 2-bit packed cDNA (~48B/read) and the device does the alignment and
# annotation.
# Per-read words:
#   0: bc_idx (int32 bits; whitelist rank or -1)
#   1: umi 2-bit packed
#   2: flags — bit0 slot_valid, bit1 umi_valid
#   3..: cDNA codes 2-bit packed (16 bases/word), then nmask bits
#        (32/word); paired-end chems append the mate's codes+mask.
#
# OUTPUT (stream mode): every [B] integer column rides one [B, NI] int32
# plane, booleans one [B, NB] bool plane, scalar metrics one [NM] vector.
I32_FIELDS = ("gene", "pos", "mapq", "strand", "aln_len", "aln_start",
              "region", "sj_donor", "sj_acceptor", "sj_right_len",
              "gene_unpaired")
# mate-2 columns appended for paired-end chemistries (presence inferred
# from the i32 plane width in unpack_step_out)
PE_I32_FIELDS = ("pos2", "mapq2", "strand2", "aln_len2", "aln_start2")
U32_FIELDS = frozenset(("gene", "pos", "sj_donor", "sj_acceptor", "pos2"))
BOOL_FIELDS = ("conf_ok", "mapped", "antisense", "novel_sj", "mm",
               "gene_discordant")
METRIC_FIELDS = ("n_mapped", "n_conf", "n_exonic", "n_intronic",
                 "n_intergenic", "n_antisense", "n_usable",
                 "n_promote_overflow", "n_tso", "n_polya_trimmed",
                 "n_improper_pair")
KG_LIST = 4  # gene_list/anti_list columns appended after I32_FIELDS


def unpack_step_out(out) -> tuple[dict, dict]:
    """Packed device step output -> (ho: named host arrays, m: metrics).

    Plane width decides the layout: [I32_FIELDS, (PE_I32_FIELDS), 2x
    KG_LIST gene lists, (4 x S secondary-locus columns)].  SE and PE
    widths differ by 5 and sec blocks come in multiples of 4, so the
    widths never collide."""
    i32 = np.asarray(out["i32"])
    flags = np.asarray(out["flags"])
    mvec = np.asarray(out["mvec"])
    ho: dict = {}
    w = i32.shape[1]
    base_se = len(I32_FIELDS) + 2 * KG_LIST
    base_pe = base_se + len(PE_I32_FIELDS)
    if (w - base_se) % 4 == 0:
        names, n_sec = I32_FIELDS, (w - base_se) // 4
    else:
        names, n_sec = I32_FIELDS + PE_I32_FIELDS, (w - base_pe) // 4
    for j, k in enumerate(names):
        col = i32[:, j]
        ho[k] = col.view(np.uint32) if k in U32_FIELDS else col
    n = len(names)
    ho["gene_list"] = i32[:, n:n + KG_LIST]
    ho["anti_list"] = i32[:, n + KG_LIST:n + 2 * KG_LIST]
    if n_sec > 0:
        o = n + 2 * KG_LIST
        ho["sec_pos"] = np.ascontiguousarray(
            i32[:, o:o + n_sec]).view(np.uint32)
        ho["sec_len"] = i32[:, o + n_sec:o + 2 * n_sec]
        ho["sec_start"] = i32[:, o + 2 * n_sec:o + 3 * n_sec]
        ho["sec_strand"] = i32[:, o + 3 * n_sec:o + 4 * n_sec]
        ho["sec_ok"] = flags[:, len(BOOL_FIELDS):len(BOOL_FIELDS) + n_sec]
    for j, k in enumerate(BOOL_FIELDS):
        ho[k] = flags[:, j]
    m = {k: int(v) for k, v in zip(METRIC_FIELDS, mvec)}
    return ho, m


def _codes_words(read_len: int) -> tuple[int, int]:
    """(code words, nmask words) per read for a packed cDNA plane."""
    return (read_len + 15) // 16, (read_len + 31) // 32


def packed_width(chem: Chemistry, read_len: int) -> int:
    rw, nw = _codes_words(read_len)
    per = rw + nw
    return 3 + per * (2 if chem.rna2 is not None else 1)


def _pack_codes_into(buf: np.ndarray, o: int, codes, nmask, L: int) -> int:
    """2-bit-pack codes [B, L] + bit-pack nmask into buf columns at o."""
    rw, nw = _codes_words(L)
    B = len(codes)
    c = codes
    if c.shape[1] < rw * 16:
        c = np.pad(c, ((0, 0), (0, rw * 16 - c.shape[1])))
    c = c.reshape(B, rw, 16).astype(np.uint32)
    w = np.zeros((B, rw), np.uint32)
    for k in range(16):
        w |= c[:, :, k] << np.uint32(2 * (15 - k))
    buf[:, o:o + rw] = w
    mb = np.packbits(np.ascontiguousarray(nmask[:, :L]), axis=1,
                     bitorder="little")
    if mb.shape[1] < nw * 4:
        mb = np.pad(mb, ((0, 0), (0, nw * 4 - mb.shape[1])))
    buf[:, o + rw:o + rw + nw] = np.ascontiguousarray(mb).view(np.uint32)
    return o + rw + nw


def pack_step_input(chem: Chemistry, read_len: int, batch,
                    bc_idx: np.ndarray) -> np.ndarray:
    """Host: assemble the single uint32 input plane for one batch."""
    B = batch.batch_size
    buf = np.zeros((B, packed_width(chem, read_len)), np.uint32)
    buf[:, 0] = np.asarray(bc_idx, np.int32).view(np.uint32)
    buf[:, 1] = batch.umi_packed
    buf[:, 2] = (batch.slot_valid.astype(np.uint32)
                 | (batch.umi_valid.astype(np.uint32) << 1))
    o = _pack_codes_into(buf, 3, batch.rna, batch.rna_nmask, read_len)
    if chem.rna2 is not None:
        _pack_codes_into(buf, o, batch.rna2, batch.rna2_nmask, read_len)
    return buf


def _unpack_codes(buf, o: int, L: int):
    """In-jit: packed columns at o -> (codes uint8 [B, L], nmask bool)."""
    rw, nw = _codes_words(L)
    B = buf.shape[0]
    w = buf[:, o:o + rw]
    shifts = (2 * (15 - jnp.arange(16))).astype(jnp.uint32)
    codes = ((w[:, :, None] >> shifts) & 3).astype(jnp.uint8) \
        .reshape(B, rw * 16)[:, :L]
    mw = buf[:, o + rw:o + rw + nw]
    bits = ((mw[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1) \
        .astype(jnp.bool_).reshape(B, nw * 32)[:, :L]
    return codes, bits


SECOND_CAP_FRAC = 4    # 2nd-locus annotation capacity = batch // 4


def _make_step(didx: DeviceIndex, ann_idx: AnnotationIndex,
               chem: Chemistry, read_len: int, accumulate: bool = False,
               emit_secondary: bool = False,
               shard_axis: str | None = None):
    """Fused jit step: align + annotate one packed batch.

    emit_secondary (BAM runs): the step also outputs the OTHER distinct
    best-scoring loci of multimapped reads (sec_* planes) so the BAM can
    write flagged secondary records (tx_annotation/src/read.rs:155,
    224-226 demote-to-secondary); off for count-only runs to keep the
    device->host planes lean.

    The input is the single uint32 plane of `pack_step_input` (bc_idx is
    already final — HOST membership + correction, see the layout comment
    above).  The genome/annotation indices are BOUND AS ARGUMENTS of the
    returned closure's inner jit: large arrays captured as jit constants
    would be embedded in the compiled program (slow compiles, and a
    compile cache key that depends on the index contents).

    Rare work is COMPACTED before it runs (jnp.nonzero with static size +
    scatter-back): second-locus annotation touches only multi-locus reads,
    SW rescue and novel-SJ discovery only low-score suspects — on real
    data all are small fractions, and every candidate probe is a whole
    row fetch (the unit of gather cost)."""
    align_impl = make_aligner(didx, read_len, bind=False,
                              shard_axis=shard_axis)
    annotate_impl = make_annotator(ann_idx, didx.genome_len, didx.sj_overhang,
                                   chem.strandedness, bind=False)
    from ..ops.trim import make_trimmer
    trim_impl = make_trimmer(read_len)
    paired = chem.rna2 is not None
    glen = didx.genome_len
    rw, nw = _codes_words(read_len)

    def _body(didx, ann_idx, buf):
        B = buf.shape[0]
        bc_idx = jax.lax.bitcast_convert_type(buf[:, 0], jnp.int32)
        umi_packed = buf[:, 1]
        flags_in = buf[:, 2]
        slot_valid = (flags_in & 1) > 0
        umi_valid = (flags_in & 2) > 0
        rna, rna_nmask = _unpack_codes(buf, 3, read_len)
        if paired:
            rna2, rna2_nmask = _unpack_codes(buf, 3 + rw + nw, read_len)

        bc_ok = (bc_idx >= 0) & slot_valid

        # ---- TSO/polyA trimming (aligner.rs:101-166): mask, don't move —
        # the aligner treats trimmed bases like N's and the CIGAR soft-clip
        # arithmetic restores them (the :404 restore, for free) ----
        tr = trim_impl(rna, rna_nmask)
        rna_nmask = tr["nmask"]

        aln = align_impl(didx, rna, rna_nmask)
        ann = annotate_impl(ann_idx, aln["pos"], aln["aln_len"],
                            aln["strand"], aln["mapq"], aln["mapped"])

        # ---- novel-splice right-segment annotation (compacted) ----
        # the left segment went through the main annotate call above
        # (aln_len = left segment for novel_sj winners); the right segment
        # is annotated here and the gene/region calls are combined
        if "novel_sj" in aln:
            C3 = max(B // SECOND_CAP_FRAC, 1)
            nsj = aln["novel_sj"] & aln["mapped"]
            nsel = jnp.nonzero(nsj, size=C3, fill_value=B)[0]
            nsel_c = jnp.minimum(nsel, B - 1)
            ann_r = annotate_impl(
                ann_idx, aln["sj_acceptor"][nsel_c],
                aln["sj_right_len"][nsel_c], aln["strand"][nsel_c],
                jnp.full((C3,), 255, jnp.int32), jnp.ones((C3,), bool))
            gr = jnp.full((B,), -1, jnp.int32).at[nsel].set(
                ann_r["gene"], mode="drop")
            rr = jnp.full((B,), REGION_INTERGENIC, jnp.int32).at[nsel].set(
                ann_r["region"], mode="drop")
            gl = ann["gene"]
            g_comb = jnp.where((gl >= 0) & ((gr == gl) | (gr < 0)), gl,
                               jnp.where((gl < 0) & (gr >= 0), gr, -1))
            gene_n = jnp.where(nsj, g_comb, ann["gene"])
            # read region = worst segment region (exonic only if both are)
            region_n = jnp.where(nsj, jnp.maximum(ann["region"], rr),
                                 ann["region"])
            conf_n = jnp.where(nsj, (aln["mapq"] == 255) & (gene_n >= 0),
                               ann["conf_mapped"])
            ann = dict(ann, gene=gene_n, region=region_n, conf_mapped=conf_n)

        # ---- compacted multi-locus annotation (2..D-locus reads) ----
        # multimapper gene promotion (tx_annotation/src/read.rs:117-149):
        # a read mapping to several loci whose alignments together hit
        # EXACTLY ONE gene is promoted to confidently-mapped, MAPQ 255.
        # Compaction is over (read, locus) PAIRS, not reads: only the VALID
        # extra loci of multimapped reads occupy annotate slots, so the
        # annotate row count stays C2 (the old 2-locus cost) while covering
        # every distinct locus the aligner surfaced.
        ND = aln["loci_pos"].shape[1]                  # D distinct loci
        C2 = max(B // SECOND_CAP_FRAC, 1)
        # saturated reads (more vote diagonals than examined candidates,
        # all examined tie) are never promoted: unexamined loci could add
        # genes we cannot see
        need2 = (aln["mapped"] & (aln["n_best"] >= 2) & ~ann["conf_mapped"]
                 & ~aln.get("saturated", jnp.zeros((B,), bool)))
        pair_ok = need2[:, None] & aln["loci_ok"][:, 1:]     # [B, ND-1]
        NP = B * (ND - 1)
        selp = jnp.nonzero(pair_ok.reshape(-1), size=C2, fill_value=NP)[0]
        selp_c = jnp.minimum(selp, NP - 1)
        lp = aln["loci_pos"][:, 1:].reshape(-1)[selp_c]
        ll = aln["loci_len"][:, 1:].reshape(-1)[selp_c]
        lst = aln["loci_strand"][:, 1:].reshape(-1)[selp_c]
        ann2_c = annotate_impl(
            ann_idx, lp, ll, lst, jnp.full((C2,), 255, jnp.int32),
            jnp.ones((C2,), bool))
        g_loci = jnp.full((NP,), GENE_NONE, jnp.int32).at[selp].set(
            ann2_c["gene"], mode="drop").reshape(B, ND - 1)
        # a read only participates if ALL its pairs got slots (pairs are
        # selected in read order, so overflow drops a suffix of reads)
        fits = jnp.cumsum(pair_ok.sum(axis=1)) <= C2
        genes_all = jnp.concatenate([ann["gene"][:, None], g_loci], axis=1)
        # exactly one distinct sense gene across loci, none multi-gene
        any_multi = (genes_all == GENE_MULTI).any(axis=1)
        gs2 = jnp.sort(genes_all, axis=1)
        isg = gs2 >= 0
        dist2 = jnp.concatenate(
            [jnp.ones((B, 1), bool), gs2[:, 1:] != gs2[:, :-1]], axis=1) & isg
        n_genes2 = dist2.sum(axis=1)
        mm_gene = jnp.max(jnp.where(isg, gs2, -1), axis=1)
        promoted = need2 & fits & (n_genes2 == 1) & ~any_multi
        gene_eff = jnp.where(promoted, mm_gene, ann["gene"])
        conf_eff = ann["conf_mapped"] | promoted
        mapq_eff = jnp.where(promoted, 255, aln["mapq"])
        ann = dict(ann, gene=gene_eff, conf_mapped=conf_eff)
        # reads whose loci pairs overflowed the promotion capacity (they
        # were never considered for promotion; counted, unlike r1)
        n_promote_overflow = jnp.sum((need2 & ~fits).astype(jnp.int32))

        # ---- paired-end mate combination (aligner.rs:422 align_read_pair,
        # read.rs:88-104 annotate_read_pe, transcript.rs:27 from_pair) ----
        # mate 2 aligns independently; a PROPER pair = both mates mapped,
        # opposite genomic strands, within the insert bound (or either on
        # a junction contig).  Pair gene = the non-empty mate's gene set,
        # or the intersection when both are non-empty.  An improper pair
        # (either mate unmapped / discordant) is unmapped as a whole
        # (new_pe at read.rs:1142-1152 treats one-sided pairs as Unmapped).
        if paired:
            # mate 2 is intentionally NOT adapter-trimmed: the reference
            # skips trimming for the 5' R2 mate ("the usual trimmer
            # doesn't apply", aligner.rs:399-402)
            aln2 = align_impl(didx, rna2, rna2_nmask)
            # mate 2 reads toward the 5' end: its sense is the flip of its
            # own genomic strand in the chemistry's frame
            ann2 = annotate_impl(ann_idx, aln2["pos"], aln2["aln_len"],
                                 aln2["strand"] ^ 1, aln2["mapq"],
                                 aln2["mapped"])
            glen_u = jnp.uint32(glen)
            strand_ok = aln2["strand"] != aln["strand"]
            on_contig = ((aln["pos"].astype(jnp.uint32) >= glen_u)
                         | (aln2["pos"].astype(jnp.uint32) >= glen_u))
            p1u = aln["pos"].astype(jnp.uint32)
            p2u = aln2["pos"].astype(jnp.uint32)
            dist = jnp.where(p2u > p1u, p2u - p1u, p1u - p2u)  # u32-safe
            proper = (aln["mapped"] & aln2["mapped"] & strand_ok
                      & (on_contig | (dist <= jnp.uint32(MAX_INSERT))))
            g1, g2 = ann["gene"], ann2["gene"]
            pair_gene = jnp.where(
                g2 == GENE_NONE, g1,
                jnp.where(g1 == GENE_NONE, g2,
                          jnp.where(g1 == g2, g1,
                                    jnp.where(g1 == GENE_MULTI, g2,
                                              jnp.where(g2 == GENE_MULTI,
                                                        g1, GENE_NONE)))))
            n_improper = jnp.sum(((aln["mapped"] | aln2["mapped"]) & ~proper
                                  & slot_valid).astype(jnp.int32))
            gene_p = jnp.where(proper, pair_gene, GENE_NONE)
            conf_p = proper & (mapq_eff == 255) & (gene_p >= 0)
            # mates each hit a specific gene but disagree -> xf
            # GENE_DISCORDANT + per-mate gX/gN tags (read.rs:1311-1319)
            gene_discordant = proper & (g1 >= 0) & (g2 >= 0) & (g1 != g2)
            gene_unpaired = g1
            ann = dict(ann, gene=gene_p, conf_mapped=conf_p)
            aln = dict(aln, mapped=proper)
            mapq_eff = jnp.where(proper, mapq_eff, 0)
            # mate-2 coordinates for the PE BAM records (both mates are
            # emitted, write_pos_bam.rs; an improper pair is unmapped as a
            # whole, so mate-2 mapped-ness is `proper` too)
            pe_out = dict(
                pos2=aln2["pos"].astype(jnp.uint32),
                mapq2=jnp.where(proper, aln2["mapq"], 0),
                strand2=aln2["strand"],
                aln_len2=aln2["aln_len"], aln_start2=aln2["aln_start"])
        else:
            n_improper = jnp.int32(0)
            gene_discordant = jnp.zeros((B,), bool)
            gene_unpaired = ann["gene"]
            pe_out = {}

        conf_ok = (ann["conf_mapped"] & bc_ok & umi_valid & slot_valid)
        mapped = aln["mapped"] & slot_valid
        m = dict(
            n_mapped=jnp.sum(mapped.astype(jnp.int32)),
            n_conf=jnp.sum((ann["conf_mapped"] & slot_valid).astype(jnp.int32)),
            n_exonic=jnp.sum((mapped & (ann["region"] == REGION_EXONIC)).astype(jnp.int32)),
            n_intronic=jnp.sum((mapped & (ann["region"] == REGION_INTRONIC)).astype(jnp.int32)),
            n_intergenic=jnp.sum((mapped & (ann["region"] == REGION_INTERGENIC)).astype(jnp.int32)),
            n_antisense=jnp.sum((mapped & ann["antisense"]).astype(jnp.int32)),
            n_usable=jnp.sum(conf_ok.astype(jnp.int32)),
            n_promote_overflow=n_promote_overflow,
            n_tso=jnp.sum((tr["matched_tso"] & slot_valid).astype(jnp.int32)),
            n_polya_trimmed=jnp.sum(
                ((tr["polya_trimmed"] > 0) & slot_valid).astype(jnp.int32)),
            n_improper_pair=n_improper,
        )
        out = dict(
            gene=jnp.maximum(ann["gene"], 0).astype(jnp.uint32),
            conf_ok=conf_ok,
            pos=aln["pos"].astype(jnp.uint32), mapq=mapq_eff,
            strand=aln["strand"],
            mapped=mapped,
            aln_len=aln["aln_len"], aln_start=aln["aln_start"],
            region=ann["region"], antisense=ann["antisense"],
            novel_sj=aln.get("novel_sj", jnp.zeros((B,), bool)),
            sj_donor=aln.get("sj_donor", jnp.zeros((B,), jnp.int32))
            .astype(jnp.uint32),
            sj_acceptor=aln.get("sj_acceptor", jnp.zeros((B,), jnp.int32))
            .astype(jnp.uint32),
            sj_right_len=aln.get("sj_right_len", jnp.zeros((B,), jnp.int32)),
            # BAM tag payloads: mm (rescued multimapper), TX/AN gene
            # lists, PE gene-discordance + unpaired gene (gX/gN)
            mm=promoted,
            gene_list=ann["gene_list"], anti_list=ann["anti_list"],
            gene_discordant=gene_discordant, gene_unpaired=gene_unpaired,
            metrics=m,
            **pe_out,
        )
        out["bc_idx"] = bc_idx
        out["umi"] = umi_packed
        if emit_secondary and not paired and aln["loci_pos"].shape[1] > 1:
            # other distinct best-score loci of multimapped reads — one
            # secondary BAM record each (read.rs:155,224-226).  Rescued/
            # promoted reads keep their secondaries too (demoted to MAPQ 0
            # by the writer, read.rs:152-156).
            out.update(
                sec_pos=aln["loci_pos"][:, 1:].astype(jnp.uint32),
                sec_len=aln["loci_len"][:, 1:],
                sec_start=aln["loci_start"][:, 1:],
                sec_strand=aln["loci_strand"][:, 1:],
                sec_ok=(aln["loci_ok"][:, 1:] & mapped[:, None]
                        & (aln["n_best"] >= 2)[:, None]))
        return out

    def _pack_stream(out, m):
        # ---- pack outputs into 3 planes (one device->host fetch each) ----
        def as_i32(a):
            if a.dtype == jnp.uint32:
                return jax.lax.bitcast_convert_type(a, jnp.int32)
            return a.astype(jnp.int32)

        names = I32_FIELDS + (PE_I32_FIELDS if "pos2" in out else ())
        ints = jnp.stack([as_i32(out[k]) for k in names], axis=1)
        ints = jnp.concatenate(
            [ints, out["gene_list"].astype(jnp.int32),
             out["anti_list"].astype(jnp.int32)], axis=1)
        if "sec_pos" in out:
            ints = jnp.concatenate(
                [ints, as_i32(out["sec_pos"]),
                 out["sec_len"].astype(jnp.int32),
                 out["sec_start"].astype(jnp.int32),
                 out["sec_strand"].astype(jnp.int32)], axis=1)
        flags = jnp.stack([out[k] for k in BOOL_FIELDS], axis=1)
        if "sec_ok" in out:
            flags = jnp.concatenate([flags, out["sec_ok"]], axis=1)
        mvec = jnp.stack([m[k] for k in METRIC_FIELDS]).astype(jnp.int32)
        return dict(i32=ints, flags=flags, mvec=mvec)

    if not accumulate:
        @jax.jit
        def step_impl(didx, ann_idx, buf):
            out = _body(didx, ann_idx, buf)
            return _pack_stream(out, out["metrics"])

        def step(buf):
            return step_impl(didx, ann_idx, buf)

        # expose for shard_map wrapping: the indices flow as replicated
        # ARGUMENTS there too, not closure constants (parallel/mesh.py)
        step.impl = step_impl
        step.bound_args = (didx, ann_idx)
        return step

    # ---- accumulate mode: outputs stay ON DEVICE between drains ----
    # The step appends its conf-mapped molecule rows, novel-SJ rows, and
    # annotated-junction histogram into donated device buffers and adds
    # its metrics into a running vector.  Steady state fetches NOTHING per
    # batch (a fetch would synchronize host and device every step); the
    # host drains the buffers in bulk every ~mol_cap/B batches.
    n_sj = int(didx.sj_rows.shape[0])
    glen_u = jnp.uint32(didx.genome_len)
    contig2 = jnp.uint32(2 * didx.sj_overhang)

    @functools.partial(jax.jit, donate_argnums=(3,))
    def step_acc_impl(didx, ann_idx, buf, acc, lib_tag):
        out = _body(didx, ann_idx, buf)
        m = out["metrics"]
        B = buf.shape[0]
        conf = out["conf_ok"]
        sel = jnp.nonzero(conf, size=B, fill_value=B)[0]
        selc = jnp.minimum(sel, B - 1)
        rows = jnp.stack(
            [jax.lax.bitcast_convert_type(out["bc_idx"], jnp.uint32)[selc],
             out["gene"][selc] | lib_tag, out["umi"][selc]], axis=1)
        n_new = jnp.sum(conf.astype(jnp.int32))
        mol = jax.lax.dynamic_update_slice(acc["mol"], rows,
                                           (acc["mol_n"], jnp.int32(0)))
        # novel splice junctions: one row per unique-mapper read (rare)
        m255 = out["mapped"] & (out["mapq"] == 255)
        nsj = out["novel_sj"] & m255
        SJB = max(B // 4, 64)   # novel-SJ rows appended per batch (cap)
        selj = jnp.nonzero(nsj, size=SJB, fill_value=B)[0]
        seljc = jnp.minimum(selj, B - 1)
        sj_rows = jnp.stack(
            [out["sj_donor"][seljc], out["sj_acceptor"][seljc],
             out["strand"][seljc].astype(jnp.uint32)], axis=1)
        n_sj_new = jnp.minimum(jnp.sum(nsj.astype(jnp.int32)), SJB)
        sj = jax.lax.dynamic_update_slice(acc["sj"], sj_rows,
                                          (acc["sj_n"], jnp.int32(0)))
        n_sj_over = jnp.maximum(jnp.sum(nsj.astype(jnp.int32)) - SJB, 0)
        # annotated-junction contig hits: exact histogram over (ji, strand)
        on_contig = m255 & (out["pos"] >= glen_u) & ~nsj
        ji = jnp.where(on_contig, (out["pos"] - glen_u) // contig2, 0)
        hidx = (ji.astype(jnp.int32) * 2
                + out["strand"].astype(jnp.int32))
        sjh = acc["sjh"].at[jnp.where(on_contig, hidx, 0)].add(
            jnp.where(on_contig, 1, 0))
        mvec = acc["mvec"] + jnp.stack(
            [m[k] for k in METRIC_FIELDS] + [n_sj_over]).astype(jnp.int32)
        return dict(mol=mol, mol_n=acc["mol_n"] + n_new,
                    sj=sj, sj_n=acc["sj_n"] + n_sj_new, sjh=sjh, mvec=mvec)

    def init_acc(mol_cap: int, sj_cap: int):
        return dict(
            mol=jnp.zeros((mol_cap, 3), jnp.uint32),
            mol_n=jnp.int32(0),
            sj=jnp.zeros((sj_cap, 3), jnp.uint32),
            sj_n=jnp.int32(0),
            sjh=jnp.zeros((max(2 * n_sj, 1),), jnp.int32),
            mvec=jnp.zeros((len(METRIC_FIELDS) + 1,), jnp.int32),
        )

    def step(buf, acc, lib_tag=0):
        return step_acc_impl(didx, ann_idx, buf, acc, jnp.uint32(lib_tag))

    step.impl = step_acc_impl
    step.bound_args = (didx, ann_idx)
    step.init_acc = init_acc
    return step


DEDUP_CHUNK_LIMIT = 1 << 26  # dedup rows per device sort (~0.8GB working set)
SPILL_PARTS = 8              # barcode-hash spill partitions (>= mesh size)


def _pow2_pad(n: int, minimum: int = 1024) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def _fb_tag_lists(pat, src, fo, fb_ref, features, n_genes: int, n: int):
    """Per-read fr/fq/fb/fx BAM tag payloads for one feature pattern
    (read.rs:1335-1360): fr/fq = raw extracted barcode seq/qual, fb = the
    matched whitelist sequence, fx = the feature id.  b'' = omit."""
    fr = [b""] * n
    fq = [b""] * n
    fb = [b""] * n
    fx = [b""] * n
    src_codes, src_nmask, _, src_qual = src
    off = np.asarray(fo["offset"])
    ext = np.asarray(fo["extracted"])
    sidx = np.asarray(fo["seq_idx"])
    feat = np.asarray(fo["feature"])
    seqs_packed = fb_ref.pattern_groups[pat][0]
    bl = pat.bc_len
    for i in np.flatnonzero(ext[:n]):
        o = int(off[i])
        fr[i] = encode.decode_codes(src_codes[i][o:o + bl],
                                    src_nmask[i][o:o + bl])
        fq[i] = bytes(src_qual[i][o:o + bl])
        if sidx[i] >= 0:
            fb[i] = encode.decode_codes(
                encode.unpack_np(np.uint32(seqs_packed[sidx[i]]), bl))
            fid = features.feature_defs[n_genes + int(feat[i])].id
            fx[i] = fid.encode() if isinstance(fid, str) else fid
    return fr, fq, fb, fx


def _tally_sj(sj_counts: dict, ho: dict, n: int, gi) -> None:
    """Vectorized splice-junction read tallies (SJ.out.tab analog): novel
    junctions from split alignments, annotated ones from junction-contig
    placements; unique mappers only.  np.unique over the batch replaces the
    r1 per-read Python loop (a wall at 1e9 reads)."""
    m255 = ho["mapped"][:n] & (ho["mapq"][:n] == 255)
    nsj = ho["novel_sj"][:n] & m255
    if nsj.any():
        dn = ho["sj_donor"][:n][nsj].astype(np.int64)
        an = ho["sj_acceptor"][:n][nsj].astype(np.int64)
        st = ho["strand"][:n][nsj].astype(np.int64)
        uniq, cnt = np.unique(np.stack([dn, an, st], 1), axis=0,
                              return_counts=True)
        for (d, a, s), c in zip(uniq.tolist(), cnt.tolist()):
            key = (d, a, s, 0)
            sj_counts[key] = sj_counts.get(key, 0) + c
    pos = ho["pos"][:n].astype(np.int64)
    on_contig = m255 & (pos >= gi.genome_len) & ~nsj
    if on_contig.any():
        ji = (pos[on_contig] - gi.genome_len) // (2 * gi.sj_overhang)
        st = ho["strand"][:n][on_contig].astype(np.int64)
        uniq, cnt = np.unique(np.stack([ji, st], 1), axis=0,
                              return_counts=True)
        for (j, s), c in zip(uniq.tolist(), cnt.tolist()):
            key = (int(gi.sj_donor_end[j]), int(gi.sj_acceptor_start[j]),
                   int(s), 1)
            sj_counts[key] = sj_counts.get(key, 0) + c


# process-level reference + compiled-step memo (most recent reference
# only).  Repeated run_count calls against one reference (multi-GEM
# wells, per-sample demux reruns, the bench's warm pass) reuse BOTH the
# device index arrays and the jit objects, so they neither re-upload the
# index nor re-trace the step — the in-process analog of the reference's shared mmap'd STAR
# index (align_and_count.rs:588 StarReference::load shares one instance).
_REF_MEMO: dict = {"key": None, "ref": None, "didx": None,
                   "ann_idx": None, "steps": {}}


def _load_reference_cached(path: str):
    from ..io.reference import ReferencePackage
    try:
        mtime = os.path.getmtime(os.path.join(path, "index.npz"))
    except OSError:
        mtime = 0.0
    key = (os.path.realpath(path), mtime)
    if _REF_MEMO["key"] != key:
        ref = ReferencePackage.load(path)
        gi = ref.genome_index
        _REF_MEMO.update(
            key=key, ref=ref, didx=DeviceIndex.from_host(gi),
            ann_idx=AnnotationIndex.build(ref.transcriptome, gi), steps={})
    return _REF_MEMO["ref"], _REF_MEMO["didx"], _REF_MEMO["ann_idx"]


def _cached_step(didx, ann_idx, chem, read_len: int, accumulate: bool,
                 emit_secondary: bool):
    """The jit'd step for the memoized reference (one compile per config
    per process, reused across run_count calls)."""
    skey = (chem.name, read_len, accumulate, emit_secondary)
    steps = _REF_MEMO["steps"]
    if _REF_MEMO["didx"] is not didx:
        # reference not from the memo (tests building raw indices):
        # fall through to an uncached step
        return _make_step(didx, ann_idx, chem, read_len,
                          accumulate=accumulate,
                          emit_secondary=emit_secondary)
    if skey not in steps:
        steps[skey] = _make_step(didx, ann_idx, chem, read_len,
                                 accumulate=accumulate,
                                 emit_secondary=emit_secondary)
    return steps[skey]


def run_count(cfg: CountConfig, out_dir: str,
              whitelist: Whitelist | None = None,
              mesh=None) -> dict:
    """Run the full count pipeline; writes outputs into out_dir and returns
    the metrics dict.

    mesh: optional jax.sharding.Mesh — the fused counting step, pass-1
    histogram, and partition dedup run SPMD over it (data-parallel reads,
    replicated index, psum metrics).  Results are identical to the
    single-chip run (the step is row-wise; dedup partitions are
    barcode-coherent; the correction-overflow retry removes the
    capacity-fraction dependence on per-device batch size).

    Multi-host (jax.process_count() > 1 after
    parallel.distributed.init_from_env): every host runs this same
    function; FASTQ pairs are round-robin assigned per host, molecule rows
    spill under the shared out_dir, and host 0 merges partials after a
    barrier — the Martian chunk/join structure over a shared filesystem
    (SURVEY §2.7 P1/P5/P7) with no per-batch cross-host synchronization.
    """
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    from ..perf import PerfTrace
    from ..parallel import distributed as dist
    from ..parallel.executor import Executor
    from .spill import MoleculeSpill
    perf = PerfTrace()
    dist.init_from_env()   # no-op without the CRTPU_* env contract
    executor = Executor(mesh)
    nproc, pid = dist.process_count(), dist.process_index()
    multihost = nproc > 1
    from ..params import get as _param
    batch_size = executor.round_batch(
        int(_param("batch_size") or cfg.batch_size))
    chem = get_chemistry(cfg.chemistry)
    if whitelist is None:
        whitelist = Whitelist.load(cfg.whitelist_path)

    probe_set = None
    if cfg.probe_set_csv:
        # RTL run: align to the probe set (Hurtle analog); no genome index
        from ..io.probe_set import ProbeSet
        from ..ops.probes import make_probe_aligner
        probe_set = ProbeSet.from_csv(cfg.probe_set_csv)
        ref = (ReferencePackage.load(cfg.reference_path)
               if cfg.reference_path else None)
        gi = None
        n_genes = len(probe_set.genes)
        from ..io.matrix_io import FeatureDef
        features = FeatureReference(
            [FeatureDef(g, g, "Gene Expression") for g in probe_set.genes])
        probe_align = make_probe_aligner(probe_set, cfg.read_len)
        probe_region_names = sorted({r or "unknown" for r in probe_set.regions})
        region_of_probe = np.asarray(
            [probe_region_names.index(r or "unknown")
             for r in probe_set.regions], np.int32)
        probe_region_reads = np.zeros(len(probe_region_names), np.int64)

    else:
        ref, didx, ann_idx = _load_reference_cached(cfg.reference_path)
        gi = ref.genome_index
        n_genes = len(ref.transcriptome.genes)
        if len(ref.genomes) > 1:
            from ..io.matrix_io import FeatureDef
            genome_per_gene = ref.genome_of_gene()
            features = FeatureReference(
                [FeatureDef(i, n_, "Gene Expression", gn)
                 for i, n_, gn in zip(ref.transcriptome.gene_ids,
                                      ref.transcriptome.gene_names,
                                      genome_per_gene)])
        else:
            features = FeatureReference.from_transcriptome(
                ref.transcriptome.gene_ids, ref.transcriptome.gene_names,
                ref.genome_name)

    # RTL sample multiplexing: probe barcode whitelist (MFRP chemistries)
    probe_bc_ids = None
    probe_bc_packed = None
    if chem.probe_bc is not None:
        if not cfg.probe_barcode_csv:
            raise ValueError(
                f"chemistry {chem.name} carries a probe barcode; pass "
                "probe_barcode_csv (id,sequence rows)")
        from ..io.probe_bc import load_probe_barcodes
        probe_bc_ids, probe_bc_packed, pbl = load_probe_barcodes(
            cfg.probe_barcode_csv)
        if pbl != chem.probe_bc.length:
            raise ValueError(
                f"probe barcodes are {pbl}bp; chemistry expects "
                f"{chem.probe_bc.length}bp")
    n_probe = len(probe_bc_ids) if probe_bc_ids else 1

    fb_ref = None
    fb_extractors = {}
    if cfg.feature_ref_csv:
        from ..io.feature_ref import FeatureBarcodeReference
        from ..ops.features import make_feature_extractor
        fb_ref = FeatureBarcodeReference.from_csv(cfg.feature_ref_csv)
        features = FeatureReference(features.feature_defs
                                    + list(fb_ref.feature_defs))
        for pat, (seqs, fidx) in fb_ref.pattern_groups.items():
            ft = BucketTable.build_exact(
                seqs, np.arange(len(seqs), dtype=np.uint32),
                entries=8, fields=3).with_counts(np.ones(len(seqs), np.int64))
            fb_extractors[pat] = make_feature_extractor(pat, ft, fidx,
                                                        cfg.read_len)

    libraries = cfg.libraries or [LibraryDef(cfg.fastq_pairs, "Gene Expression")]
    if len(features.feature_defs) >= (1 << LIB_SHIFT) or len(libraries) > 255:
        raise ValueError("feature reference / library count exceeds the "
                         "24-bit gene + 8-bit library packing")
    metrics = CountMetrics()

    perf.lap("load_reference_index")

    # ---- checkpoint/resume (pipestance analog, pipeline/checkpoint.py) ----
    ckpt = None
    _resume = None
    if cfg.checkpoint and not multihost:
        from .checkpoint import CountCheckpoint, count_fingerprint
        ckpt = CountCheckpoint(out_dir, count_fingerprint(cfg))
        _resume = ckpt.load("molecules")
        if _resume is not None and cfg.write_bam:
            # a BAM run resumes only when its sealed band spool (the
            # journal; VERDICT r3 item 7, mrp_args.rs:57-65 pipestance
            # resume) AND the raw-triple views survive with the table
            if not (_resume["__meta__"].get("bam_spool_sealed")
                    and os.path.isdir(os.path.join(out_dir, "_bam_spool"))
                    and "rv_raw_bc" in _resume):
                _resume = None
    if _resume is not None:
        mbc = _resume["mbc"]; mgene = _resume["mgene"]
        mumi = _resume["mumi"]; mreads = _resume["mreads"]
        mlib = _resume.get("mlib", np.zeros(len(mbc), np.uint16))
        sjk = _resume["sj_keys"]; sjv = _resume["sj_vals"]
        sj_counts = {tuple(int(x) for x in k): int(v)
                     for k, v in zip(sjk, sjv)}
        if probe_set is not None and "probe_region_reads" in _resume:
            probe_region_reads = _resume["probe_region_reads"]
        metrics = CountMetrics(**_resume["__meta__"]["metrics"])
        bam_collector = None
        raw_views = None
        if cfg.write_bam and gi is not None:
            # reopen the sealed band spool read-only; the FASTQ passes are
            # skipped and the run goes straight to band merge
            from .bam_out import BamCollector
            bam_collector = BamCollector(
                gi, ref.transcriptome,
                os.path.join(out_dir, "_bam_spool"),
                read_group=cfg.sample_id, fresh=False)
            bam_collector.n_reads = int(
                _resume["__meta__"].get("bam_n_reads", 0))
            raw_views = {k[3:]: _resume[k] for k in _resume
                         if k.startswith("rv_")}
        perf.lap("resume_checkpoint")
    else:
        # accumulate mode (single-chip, no BAM): step outputs stay on
        # device between bulk drains — steady state fetches nothing per
        # batch.  BAM needs per-read outputs (stream mode), and the mesh
        # path streams too (its outputs shard across devices).
        accumulate = (probe_set is None and not cfg.write_bam
                      and executor.mesh is None)
        if (cfg.shard_index and executor.mesh is not None
                and probe_set is None):
            # sharded-index mode: kmer-table rows shard over the mesh,
            # the aligner's seed lookup rides the all_to_all exchange
            from jax.sharding import PartitionSpec as _P
            from ..parallel.index_shard import shard_device_index
            didx_sh, didx_spec = shard_device_index(
                didx, executor.mesh, executor.axis)
            base = _make_step(didx_sh, ann_idx, chem, cfg.read_len,
                              accumulate=accumulate,
                              emit_secondary=cfg.write_bam,
                              shard_axis=executor.axis)
            base.bound_specs = (didx_spec, _P())
            step = executor.wrap_step(base, n_batch_args=1)
        else:
            step = (None if probe_set is not None
                    else executor.wrap_step(
                        _cached_step(didx, ann_idx, chem, cfg.read_len,
                                     accumulate, cfg.write_bam),
                        n_batch_args=1))

        # this host's share of the FASTQ work (all of it when single-host)
        # (pairs may be (r1, r2) or (r1, r2, i1) — I1 carries the barcode
        # for SC3Pv1)
        # ---- multihost resume (SURVEY §5.4, mrp_args.rs:57-65 pipestance
        # resume of any jobmode): a host whose per-host partial
        # (_spill/host{pid}.json, written AFTER its spill flushed) carries
        # the current input fingerprint skips both FASTQ passes — the
        # spill files + partial are its durable pass-2 state.  Resume must
        # be UNANIMOUS (otherwise the spill-clean below would delete
        # completed hosts' files while another host restarts), so hosts
        # vote through the allsum collective.  BAM/feature/RTL runs keep
        # per-read state outside the spill and always rerun.
        mh_fp = None
        mh_resume = False
        if (multihost and cfg.checkpoint and not cfg.write_bam
                and probe_set is None and fb_ref is None):
            from .checkpoint import count_fingerprint
            mh_fp = count_fingerprint(cfg)
            try:
                with open(os.path.join(out_dir, "_spill",
                                       f"host{pid}.json")) as f:
                    mine_ok = json.load(f).get("fingerprint") == mh_fp
            except Exception:
                mine_ok = False
            votes = dist.allsum_array(np.array([1 if mine_ok else 0]))
            mh_resume = int(votes[0]) == nproc
        work = [(li, pair) for li, lib in enumerate(libraries)
                for pair in lib.fastq_pairs]
        my_work = dist.host_shard(work) if multihost else work
        if mh_resume:
            my_work = []   # durable pass-2 state on disk: nothing to read

        # feature patterns declared on R1 need the R1-remainder view
        need_r1_rest = any(pat.read == "R1" for pat in fb_extractors)

        def my_batches(barcode_only: bool = False):
            for li, pair in my_work:
                r1, r2 = pair[0], pair[1]
                i1 = pair[2] if len(pair) > 2 else None
                is_fb = libraries[li].library_type != "Gene Expression"
                for batch in batches_from_fastqs(
                        chem, r1, r2, batch_size, cfg.read_len,
                        keep_names=cfg.write_bam and not barcode_only,
                        i1_path=i1,
                        keep_r1_rest=need_r1_rest and is_fb
                        and not barcode_only,
                        barcode_only=barcode_only):
                    yield li, batch

        # ---- pass 1 (== MAKE_SHARD): stream + count valid barcodes ----
        # HOST-ONLY: whitelist membership of 2-bit-packed barcodes is one
        # vectorized searchsorted against the sorted whitelist — no device
        # round trips, no compiles, and barcode_only decode never opens the
        # cDNA read (half the IO).  Nothing is cached: pass 2 re-streams
        # the FASTQs, so peak host RAM is O(one batch) — the
        # SpillVec/shardio discipline (spill_vec.rs) instead of an
        # all-in-RAM batch list.  q30 base tallies happen in pass 2 where
        # the quals are decoded anyway.
        wl_counts = np.zeros(whitelist.size, np.int64)
        for li, batch in my_batches(barcode_only=True):
            idx = whitelist.index_of(batch.bc_packed[:batch.n_reads])
            np.add.at(wl_counts, idx[idx >= 0], 1)
        # one cross-host collective merges the histogram (Metric::merge of
        # MAKE_SHARD's join); every host needs the global prior for pass 2
        wl_counts = dist.allsum_array(wl_counts)

        perf.lap("pass1_extract_whitelist")

        # ---- pass 2: host barcode resolve + fused align/annotate step ----
        def resolve_bc(batch):
            """Host membership + posterior correction with the pass-1
            prior; returns (bc_idx, hit, corrected, corrected_bc)."""
            return bcops.host_resolve_barcodes(
                batch.bc_packed, batch.bc_qual, batch.slot_valid,
                whitelist.sorted_seqs, wl_counts, chem.barcode_length)

        n_parts = int(_param("spill_partitions") or
                      (SPILL_PARTS if executor.n_devices <= SPILL_PARTS
                       else executor.n_devices))
        if multihost and not mh_resume:
            # clear STALE spill files from a prior failed run (a smaller
            # host set would otherwise leave old host*_part files that
            # load_union would silently merge)
            if pid == 0:
                import glob as _glob
                import shutil as _shutil
                for f in _glob.glob(os.path.join(out_dir, "_spill", "*")):
                    os.remove(f)
                _shutil.rmtree(os.path.join(out_dir, "_bam_spool"),
                               ignore_errors=True)
            dist.barrier("spill-clean")
        spill = MoleculeSpill(os.path.join(out_dir, "_spill"), n_parts,
                              prefix=f"host{pid}_" if multihost else "",
                              append=mh_resume)
        sj_counts: dict = {}   # (donor, acceptor, strand, annotated) -> reads
        bam_collector = None
        if cfg.write_bam and gi is not None:
            from .bam_out import BamCollector
            # multihost: per-host band spools under the shared out dir;
            # host 0 merges every host's bands at write time (the
            # write_pos_bam.rs:65-101 per-chunk spool + cat analog)
            bam_spool_dir = (os.path.join(out_dir, "_bam_spool",
                                          f"host{pid}")
                             if multihost
                             else os.path.join(out_dir, "_bam_spool"))
            bam_collector = BamCollector(gi, ref.transcriptome,
                                         bam_spool_dir,
                                         read_group=cfg.sample_id)
        # ---- producer thread + device pipeline (par_proc.rs:106 analog):
        # the producer decodes, resolves barcodes, and packs the next
        # batches while the main thread dispatches to the device.  In
        # stream mode a 1-deep pending slot additionally overlaps the
        # fetch with the next dispatch; in accumulate mode there is no
        # per-batch fetch at all.
        pending: tuple | None = None

        def prep(item):
            li, batch = item
            if (libraries[li].library_type == "Gene Expression"
                    and probe_set is None):
                bc_idx, hit, corrected, corr_bc = resolve_bc(batch)
                buf = pack_step_input(chem, cfg.read_len, batch, bc_idx)
                hi = dict(bc_idx=bc_idx, corr_bc=corr_bc,
                          n_valid_bc=int(hit.sum()),
                          n_corrected=int(corrected.sum()),
                          n_valid_umi=int((batch.umi_valid
                                           & batch.slot_valid).sum()))
                # device_put HERE, on the producer thread: the host->
                # device transfer of the packed plane overlaps the
                # previous batch's step instead of serializing with it
                return li, batch, hi, executor.put(buf)
            return li, batch, None, None

        bq: _queue.Queue = _queue.Queue(maxsize=3)

        def _producer():
            try:
                for item in my_batches():
                    bq.put(prep(item))
                bq.put(None)
            except BaseException as e:  # re-raised on the main thread
                bq.put(e)

        threading.Thread(target=_producer, daemon=True).start()

        def queued_batches():
            while True:
                item = bq.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item

        # accumulate-mode state: device-resident output buffers + host
        # bounds that guarantee the in-jit dynamic appends never clamp
        mol_cap = max(4 * batch_size, 1 << 20)
        sj_cap = max(4 * batch_size, 1 << 18)
        sjb_per_batch = max(batch_size // 4, 64)
        acc = step.init_acc(mol_cap, sj_cap) if accumulate else None
        acc_rows = 0
        acc_sj_rows = 0
        sjh_total = None
        sj_capacity_overflow = 0
        # device-resident dedup (count-only runs): drained molecule rows
        # absorb into an exact-merged on-device table instead of spilling
        # to host — dedup overlaps pass 2 and the only host traffic is
        # the final valid-molecule fetch (mark_dups runs inside
        # ALIGN_AND_COUNT's pass for the same reason,
        # align_and_count.rs:292-333).  BAM/feature runs need raw-triple
        # views and multihost runs exchange through the spill dir, so
        # both keep the spill path.
        keep_raw_run = cfg.write_bam or fb_ref is not None
        mol_state = None
        if accumulate and not multihost and not keep_raw_run:
            from ..parallel.executor import MoleculeState
            mol_state = MoleculeState(1 << 23, chem.umi_length)

        def drain_acc():
            """Fetch + reset the device accumulators: spill molecule rows,
            tally SJ rows, fold metrics.  Called every ~mol_cap reads and
            once at the end of the pass."""
            nonlocal acc, acc_rows, acc_sj_rows, sjh_total, \
                sj_capacity_overflow
            if mol_state is not None:
                mol_state.absorb(acc["mol"], acc["mol_n"], acc_rows)
                a = {k: np.asarray(v) for k, v in acc.items()
                     if k not in ("mol", "mol_n")}
                a["mol_n"] = 0
            else:
                a = jax.tree.map(np.asarray, acc)
                nmol = int(a["mol_n"])
                rows = a["mol"][:nmol]
                spill.append(rows[:, 0], rows[:, 1], rows[:, 2])
            nsj = int(a["sj_n"])
            if nsj:
                u, c = np.unique(a["sj"][:nsj], axis=0, return_counts=True)
                for (d, ac_, s), cnt in zip(u.tolist(), c.tolist()):
                    key = (d, ac_, s, 0)
                    sj_counts[key] = sj_counts.get(key, 0) + cnt
            sjh_total = (a["sjh"] if sjh_total is None
                         else sjh_total + a["sjh"])
            mv = a["mvec"]
            m = {k: int(v) for k, v in zip(METRIC_FIELDS, mv)}
            sj_capacity_overflow += int(mv[-1])
            metrics.mapped_reads += m["n_mapped"]
            metrics.conf_mapped_reads += m["n_conf"]
            metrics.exonic_reads += m["n_exonic"]
            metrics.intronic_reads += m["n_intronic"]
            metrics.intergenic_reads += m["n_intergenic"]
            metrics.antisense_reads += m["n_antisense"]
            metrics.usable_reads += m["n_usable"]
            metrics.promote_overflow += m["n_promote_overflow"]
            metrics.tso_reads += m["n_tso"]
            metrics.polya_trimmed_reads += m["n_polya_trimmed"]
            metrics.improper_pair_reads += m["n_improper_pair"]
            acc = step.init_acc(mol_cap, sj_cap)
            acc_rows = 0
            acc_sj_rows = 0

        def process_gex(li, batch, hi, out):
            ho, m = unpack_step_out(out)
            lib_bits = np.uint32(li << LIB_SHIFT)
            metrics.total_reads += batch.n_reads
            metrics.valid_barcode_reads += hi["n_valid_bc"] + hi["n_corrected"]
            metrics.corrected_barcode_reads += hi["n_corrected"]
            metrics.valid_umi_reads += hi["n_valid_umi"]
            metrics.mapped_reads += m["n_mapped"]
            metrics.conf_mapped_reads += m["n_conf"]
            metrics.exonic_reads += m["n_exonic"]
            metrics.intronic_reads += m["n_intronic"]
            metrics.intergenic_reads += m["n_intergenic"]
            metrics.antisense_reads += m["n_antisense"]
            metrics.usable_reads += m["n_usable"]
            metrics.promote_overflow += m["n_promote_overflow"]
            metrics.tso_reads += m["n_tso"]
            metrics.polya_trimmed_reads += m["n_polya_trimmed"]
            metrics.improper_pair_reads += m["n_improper_pair"]
            conf = ho["conf_ok"]
            spill.append(hi["bc_idx"].view(np.uint32)[conf],
                         ho["gene"][conf] | lib_bits, batch.umi_packed[conf])
            _tally_sj(sj_counts, ho, batch.n_reads, gi)
            if bam_collector is not None:
                # merge the host-resolved barcode view into the step output
                ho["bc_idx"] = hi["bc_idx"]
                ho["bc_ok"] = hi["bc_idx"] >= 0
                ho["corrected_bc"] = hi["corr_bc"]
                ho["umi"] = batch.umi_packed
                # library-tagged gene: the dedup raw-triple join key
                ho["gene_lib"] = ho["gene"] | lib_bits
                bam_collector.add_batch(batch, ho)

        for li, batch, hi, buf in queued_batches():
            # q30 base tallies (host; quals are decoded here anyway)
            n0 = batch.n_reads
            metrics.q30_bc_bases += int((batch.bc_qual[:n0] >= 63).sum())
            metrics.bc_bases += int(batch.bc_qual[:n0].size)
            metrics.q30_umi_bases += int((batch.umi_qual[:n0] >= 63).sum())
            metrics.umi_bases += int(batch.umi_qual[:n0].size)
            in_len = batch.rna_qual[:n0][batch.rna_nmask[:n0]]
            metrics.q30_rna_bases += int((in_len >= 63).sum())
            metrics.rna_bases += int(in_len.size)
            if batch.rna2 is not None:   # paired-end mate counts too
                in2 = batch.rna2_qual[:n0][batch.rna2_nmask[:n0]]
                metrics.q30_rna_bases += int((in2 >= 63).sum())
                metrics.rna_bases += int(in2.size)
            lib_type = libraries[li].library_type
            if lib_type != "Gene Expression" or probe_set is not None:
                # non-step paths run synchronously; flush the pipeline
                if pending is not None:
                    process_gex(*pending)
                    pending = None
            if lib_type == "Gene Expression" and probe_set is not None:
                # RTL: host cell-barcode resolve + probe alignment
                bc_idx, hit, corrected, corr_bc = resolve_bc(batch)
                bc_ok = bc_idx >= 0
                n_corrected = int(corrected.sum())
                pa = probe_align(jnp.asarray(batch.rna),
                                 jnp.asarray(batch.rna_nmask))
                conf = (np.asarray(pa["conf_mapped"]) & bc_ok
                        & batch.umi_valid)
                bc_combined = bc_idx.astype(np.int64)
                if probe_bc_packed is not None:
                    from ..io.probe_bc import assign_probe_bcs
                    pidx, pok = assign_probe_bcs(
                        batch.probe_bc_packed, probe_bc_packed,
                        chem.probe_bc.length)
                    conf = conf & pok
                    bc_combined = bc_combined * n_probe + np.maximum(pidx, 0)
                metrics.total_reads += batch.n_reads
                metrics.valid_barcode_reads += int(bc_ok.sum())
                metrics.corrected_barcode_reads += int(n_corrected)
                metrics.valid_umi_reads += int(
                    (batch.umi_valid & batch.slot_valid).sum())
                metrics.mapped_reads += int(np.asarray(pa["mapped"]).sum())
                metrics.conf_mapped_reads += int(np.asarray(pa["conf_mapped"]).sum())
                metrics.usable_reads += int(conf.sum())
                probes_conf = np.asarray(pa["probe"])[conf]
                np.add.at(probe_region_reads, region_of_probe[probes_conf], 1)
                spill.append(bc_combined.astype(np.uint32)[conf],
                             np.asarray(pa["gene"])[conf].astype(np.uint32)
                             | np.uint32(li << LIB_SHIFT),
                             np.asarray(batch.umi_packed)[conf])
            elif lib_type == "Gene Expression" and accumulate:
                if (acc_rows + batch.batch_size > mol_cap
                        or acc_sj_rows + sjb_per_batch > sj_cap):
                    drain_acc()
                acc = step(buf, acc,
                           lib_tag=np.uint32(li << LIB_SHIFT))
                acc_rows += batch.batch_size
                acc_sj_rows += sjb_per_batch
                metrics.total_reads += batch.n_reads
                metrics.valid_barcode_reads += (hi["n_valid_bc"]
                                                + hi["n_corrected"])
                metrics.corrected_barcode_reads += hi["n_corrected"]
                metrics.valid_umi_reads += hi["n_valid_umi"]
            elif lib_type == "Gene Expression":
                out = step(buf)
                if pending is not None:
                    process_gex(*pending)
                pending = (li, batch, hi, out)
            else:
                # feature-barcode library: cell bc handling + feature
                # extraction over every declared pattern (R1 patterns read
                # the R1 remainder, R2 patterns the cDNA read —
                # feature_extraction.rs:166 supports both)
                bc_idx, hit, corrected, corr_bc = resolve_bc(batch)
                bc_ok = bc_idx >= 0
                metrics.total_reads += batch.n_reads
                metrics.valid_barcode_reads += int(bc_ok.sum())
                metrics.corrected_barcode_reads += int(corrected.sum())
                metrics.valid_umi_reads += int(
                    (batch.umi_valid & batch.slot_valid).sum())
                bc_ok_np = bc_ok
                n = batch.n_reads
                fb_rows = None  # per-read best extraction across patterns
                for pat, extract in fb_extractors.items():
                    if pat.read == "R1":
                        if batch.r1_rest is None:
                            continue
                        src = (batch.r1_rest, batch.r1_rest_nmask,
                               batch.r1_rest_len, batch.r1_rest_qual)
                    else:
                        src = (batch.rna, batch.rna_nmask, batch.rna_len,
                               batch.rna_qual)
                    fo = extract(jnp.asarray(src[0]), jnp.asarray(src[1]),
                                 jnp.asarray(src[2]))
                    found_n = np.asarray(fo["found"])[:n]
                    ext = np.asarray(fo["extracted"])[:n]
                    gene_n = (np.asarray(fo["feature"])[:n]
                              + n_genes).astype(np.uint32)
                    if bam_collector is not None:
                        fr, fq, fbs, fx = _fb_tag_lists(
                            pat, src, fo, fb_ref, features, n_genes, n)
                    else:
                        fr = fq = fbs = fx = [b""] * n
                    if fb_rows is None:
                        fb_rows = dict(
                            fr=fr, fq=fq, fb=fbs, fx=fx,
                            found=found_n.copy(), extracted=ext.copy(),
                            gene=gene_n.copy())
                    else:
                        # ONE feature per read across patterns (the
                        # reference extracts a single FeatureExtracted per
                        # read): a pattern that FOUND a whitelist match
                        # beats one that merely extracted bases; otherwise
                        # first extraction wins
                        use = (found_n & ~fb_rows["found"])                             | (ext & ~fb_rows["extracted"])
                        for i in np.flatnonzero(use):
                            fb_rows["fr"][i] = fr[i]
                            fb_rows["fq"][i] = fq[i]
                            fb_rows["fb"][i] = fbs[i]
                            fb_rows["fx"][i] = fx[i]
                        fb_rows["gene"] = np.where(use, gene_n,
                                                   fb_rows["gene"])
                        fb_rows["found"] |= found_n
                        fb_rows["extracted"] |= ext
                if fb_rows is not None:
                    conf = (fb_rows["found"] & bc_ok_np[:n]
                            & batch.umi_valid[:n])
                    fb_rows["conf"] = conf
                    metrics.usable_reads += int(conf.sum())
                    metrics.conf_mapped_reads += int(conf.sum())
                    spill.append(
                        np.asarray(bc_idx).astype(np.uint32)[:n][conf],
                        fb_rows["gene"][conf] | np.uint32(li << LIB_SHIFT),
                        np.asarray(batch.umi_packed)[:n][conf])
                if bam_collector is not None and fb_rows is not None:
                    bam_collector.add_feature_batch(
                        batch, fb_rows["conf"], bc_ok_np,
                        np.asarray(bc_idx), np.asarray(corr_bc),
                        fb_rows["gene"], fb_rows["fr"], fb_rows["fq"],
                        fb_rows["fb"], fb_rows["fx"],
                        gene_lib=fb_rows["gene"]
                        | np.uint32(li << LIB_SHIFT))

            perf.lap("pass2_correct_align_annotate")
        if pending is not None:
            process_gex(*pending)
            pending = None
        if accumulate and acc is not None:
            drain_acc()
            # annotated-junction contig hits: exact device histogram over
            # (junction, strand) -> the (donor, acceptor, strand, 1) keys
            if sjh_total is not None:
                for h in np.flatnonzero(sjh_total):
                    ji, s = int(h) // 2, int(h) % 2
                    key = (int(gi.sj_donor_end[ji]),
                           int(gi.sj_acceptor_start[ji]), s, 1)
                    sj_counts[key] = sj_counts.get(key, 0) + int(sjh_total[h])
            metrics.sj_capacity_overflow += sj_capacity_overflow
        perf.lap("pass2_correct_align_annotate")

        # ---- multi-host handoff: workers publish partials and exit ----
        # (the Martian chunk/join boundary: spill files + a metrics JSON on
        # the shared filesystem; host 0 is the join)
        spill.flush()
        if multihost:
            if not mh_resume:
                partial = dict(
                    metrics=dict(metrics.__dict__),
                    sj=[[list(k), v] for k, v in sorted(sj_counts.items())],
                    fingerprint=mh_fp)
                if probe_set is not None:
                    partial["probe_region_reads"] = \
                        probe_region_reads.tolist()
                # atomic publish: the partial is the durable "my pass 2 is
                # complete" marker for multihost resume
                pj = os.path.join(out_dir, "_spill", f"host{pid}.json")
                with open(pj + ".tmp", "w") as f:
                    json.dump(partial, f)
                os.replace(pj + ".tmp", pj)
            if bam_collector is not None:
                bam_collector.spool.seal()
            dist.barrier("count-spill")
            if os.environ.get("CRTPU_TEST_DIE_AFTER_PASS2"):
                # test hook: simulated whole-job crash at the point where
                # every host's pass-2 state is durable (resume coverage)
                raise SystemExit(42)
            if pid != 0:
                spill.close(remove=False)
                return {"worker": pid, "total_reads": metrics.total_reads}
            if bam_collector is not None:
                # host 0 merges every host's band spools at write time
                import glob as _glob
                bam_collector.sibling_dirs = sorted(
                    d for d in _glob.glob(
                        os.path.join(out_dir, "_bam_spool", "host*"))
                    if os.path.basename(d) != f"host{pid}")
            # host 0: fold every host's metric partial (Metric::merge)
            merged = CountMetrics()
            sj_counts = {}
            if probe_set is not None:
                probe_region_reads = np.zeros_like(probe_region_reads)
            import glob as _glob
            for path in sorted(_glob.glob(
                    os.path.join(out_dir, "_spill", "host*.json"))):
                with open(path) as f:
                    part = json.load(f)
                for k, v in part["metrics"].items():
                    setattr(merged, k, getattr(merged, k) + v)
                for k, v in part["sj"]:
                    key = tuple(k)
                    sj_counts[key] = sj_counts.get(key, 0) + v
                if probe_set is not None:
                    probe_region_reads += np.asarray(
                        part["probe_region_reads"], np.int64)
            metrics = merged

        # ---- dedup over barcode-hash partitions (bounded memory) ----
        # each spill partition holds complete barcodes; oversized
        # partitions sub-split by a second barcode hash, so the device sort
        # working set stays <= DEDUP_CHUNK_LIMIT rows regardless of run size
        keep_raw = bam_collector is not None or fb_ref is not None
        if mol_state is not None and not mol_state.flushed:
            # device-resident path: everything already merged on device;
            # one dedup call + one valid-molecule fetch
            mbc, mgene, mumi, mreads = mol_state.finalize()
            parts_out, raw_parts = [], []
        else:
            parts = []
            if mol_state is not None:
                # overflow path: the merged state flushed to host; dedup
                # its reads-weighted rows over bc-hash partitions
                fb_, fg_, fu_, fr_ = mol_state.finalize()
                k = max(1, -(-len(fb_) // DEDUP_CHUNK_LIMIT))
                sub = (fb_ * np.uint32(0x9E3779B9)) % np.uint32(k)
                for j in range(k):
                    msk = sub == j
                    parts.append((fb_[msk], fg_[msk], fu_[msk], fr_[msk]))
            for p in range(n_parts):
                if multihost:
                    b, g, u = MoleculeSpill.load_union(
                        os.path.join(out_dir, "_spill"), n_parts, p)
                else:
                    b, g, u = spill.load_part(p)
                k = max(1, -(-len(b) // DEDUP_CHUNK_LIMIT))
                if k == 1:
                    if len(b):
                        parts.append((b, g, u))
                else:
                    sub = (b // np.uint32(n_parts)) % np.uint32(k)
                    for j in range(k):
                        msk = sub == j
                        parts.append((b[msk], g[msk], u[msk]))
            parts_out = []
            raw_parts = []
            for dd in executor.dedup_partitions(parts, chem.umi_length,
                                                keep_raw=keep_raw):
                parts_out.append((dd["mol_bc"], dd["mol_gene"],
                                  dd["mol_umi"], dd["mol_reads"]))
                if keep_raw:
                    raw_parts.append(dd)
            mbc = np.concatenate([x[0] for x in parts_out])
            mgene = np.concatenate([x[1] for x in parts_out])
            mumi = np.concatenate([x[2] for x in parts_out])
            mreads = np.concatenate([x[3] for x in parts_out])
        # strip the library tag out of the gene column (set at spill time
        # so dedup ran per-library, like the reference's per-library chunks)
        mlib = (mgene >> np.uint32(LIB_SHIFT)).astype(np.uint16)
        mgene = mgene & LIB_MASK
        order = np.lexsort((mumi, mgene, mbc))
        mbc, mgene, mumi, mreads, mlib = (mbc[order], mgene[order],
                                          mumi[order], mreads[order],
                                          mlib[order])
        metrics.total_molecules = int(len(mbc))
        raw_views = None
        if keep_raw:
            raw_views = {k: np.concatenate([rp[k] for rp in raw_parts])
                         for k in ("raw_bc", "raw_gene", "raw_umi",
                                   "raw_corr_umi", "raw_low", "raw_reads")}
        spill.close(remove=True)

        perf.lap("dedup")
        if ckpt is not None:
            sj_items = sorted(sj_counts.items())
            save = dict(mbc=mbc, mgene=mgene, mumi=mumi, mreads=mreads,
                        mlib=mlib,
                        sj_keys=np.asarray([k for k, _ in sj_items],
                                           np.int64).reshape(-1, 4),
                        sj_vals=np.asarray([v for _, v in sj_items],
                                           np.int64))
            if probe_set is not None:
                save["probe_region_reads"] = probe_region_reads
            meta = dict(metrics=dict(metrics.__dict__))
            if bam_collector is not None and not multihost:
                # the band spool becomes the journal: seal it and persist
                # the raw-triple views so a killed --bam run resumes
                # straight to band merge (VERDICT r3 item 7)
                bam_collector.spool.seal()
                for k_, v_ in (raw_views or {}).items():
                    save[f"rv_{k_}"] = v_
                meta.update(bam_spool_sealed=True,
                            bam_n_reads=bam_collector.n_reads)
            ckpt.save("molecules", save, meta=meta)

    # ---- matrix assembly over the full whitelist barcode space ----
    # translated whitelists (whitelist.rs WithTranslation) emit the
    # translated barcode downstream
    out_seqs = (whitelist.translation if whitelist.translation is not None
                else whitelist.sorted_seqs)
    suffix = f"-{cfg.gem_group}".encode()
    if probe_bc_packed is not None:
        # product barcode space: gel-bead barcode ++ probe barcode
        # (DEMUX_PROBE_BC_MATRIX barcode composition)
        probe_strs = [encode.decode_codes(encode.unpack_np(
            np.uint32(p), chem.probe_bc.length)) for p in probe_bc_packed]
        barcodes = [
            encode.decode_codes(encode.unpack_np(s, whitelist.length))
            + ps + suffix
            for s in out_seqs for ps in probe_strs]
    else:
        barcodes = [encode.decode_codes(encode.unpack_np(s, whitelist.length))
                    + suffix for s in out_seqs]
    raw = CountMatrix.from_molecules(mbc.astype(np.int64), mgene.astype(np.int64),
                                     barcodes, features)
    raw.save_h5(os.path.join(out_dir, "raw_feature_bc_matrix.h5"),
                chemistry_description=chem.description)
    raw.save_mex(os.path.join(out_dir, "raw_feature_bc_matrix"))

    perf.lap("matrix_assembly")

    # ---- antibody/antigen aggregate-GEM removal (FILTER_BARCODES step 1,
    # cell_calling_helpers.py:188-272) ----
    agg_metrics: dict = {}
    agg_bcs = np.zeros(0, np.int64)
    if fb_ref is not None:
        from ..analysis.aggregates import (detect_antibody_aggregates,
                                           detect_outlier_umi_bcs)
        fdefs = features.feature_defs
        ab_rows = [i for i, d in enumerate(fdefs)
                   if d.feature_type == "Antibody Capture"]
        ag_rows = [i for i, d in enumerate(fdefs)
                   if d.feature_type == "Antigen Capture"]
        if ab_rows:
            agg_bcs = detect_antibody_aggregates(
                np.asarray(raw.m[ab_rows, :].todense()),
                num_probe_barcodes=n_probe if n_probe > 1 else None)
        if ag_rows:
            agg_bcs = np.union1d(agg_bcs, detect_outlier_umi_bcs(
                np.asarray(raw.m[ag_rows, :].todense())))
        # highly-corrected-reads signal (antibody/analysis.py:91-99): a
        # barcode whose FB reads are mostly UMI corrections is aggregate
        if raw_views is not None and len(raw_views["raw_bc"]):
            from ..analysis.aggregates import detect_highly_corrected_bcs
            fb_mask = (raw_views["raw_gene"] & LIB_MASK) >= np.uint32(n_genes)
            rb = raw_views["raw_bc"][fb_mask].astype(np.int64)
            rreads = raw_views["raw_reads"][fb_mask].astype(np.int64)
            rcorr = (raw_views["raw_corr_umi"]
                     != raw_views["raw_umi"])[fb_mask]
            space = whitelist.size * n_probe
            reads_per = np.bincount(rb, weights=rreads,
                                    minlength=space)
            corr_per = np.bincount(rb[rcorr], weights=rreads[rcorr],
                                   minlength=space)
            agg_bcs = np.union1d(agg_bcs, detect_highly_corrected_bcs(
                reads_per, corr_per))
        if len(agg_bcs):
            per_bc_all = raw.counts_per_bc()
            agg_metrics["number_aggregate_GEMs"] = int(len(agg_bcs))
            agg_metrics["reads_lost_to_aggregate_GEMs"] = float(
                per_bc_all[agg_bcs].sum() / max(per_bc_all.sum(), 1))
            with open(os.path.join(out_dir, "aggregate_barcodes.csv"),
                      "w") as f:
                f.write("barcode,umis\n")
                for b in agg_bcs:
                    bc = raw.barcodes[b]
                    f.write(f"{bc.decode() if isinstance(bc, bytes) else bc},"
                            f"{int(per_bc_all[b])}\n")

    # ---- cell calling (on Gene Expression counts only when FB present,
    # filter_barcodes semantics) ----
    if fb_ref is not None and n_genes > 0:
        gex_m = raw.m[:n_genes]
        umis_per_bc = np.asarray(gex_m.sum(axis=0)).ravel()
        call_matrix = gex_m
    else:
        umis_per_bc = raw.counts_per_bc()
        call_matrix = raw.m
    if len(agg_bcs):
        # aggregates never become cells (the reference removes them from
        # the matrix before calling; we zero their calling weight instead
        # so raw-matrix barcode indexing stays stable)
        umis_per_bc = umis_per_bc.copy()
        umis_per_bc[agg_bcs] = 0
    if cfg.cell_calling_mode == "gradient" and cfg.force_cells is None:
        # targeted-panel steepest-gradient caller (helpers.py:992-1083)
        cells_idx, call_metrics = cell_calling.call_cells_gradient(
            umis_per_bc, recovered_cells=cfg.recovered_cells)
    else:
        cells_idx, call_metrics = cell_calling.call_cells(
            call_matrix, umis_per_bc, cfg.chemistry,
            recovered_cells=cfg.recovered_cells, force_cells=cfg.force_cells,
            num_probe_bcs=n_probe if n_probe > 1 else None)
    if len(agg_bcs):
        cells_idx = np.setdiff1d(np.asarray(cells_idx), agg_bcs)
        call_metrics.update(agg_metrics)
    # post-call filters (filter_barcodes/__init__.py:553-575)
    cells_idx = cell_calling.apply_min_umi_filter(
        umis_per_bc, cells_idx, cfg.global_minimum_umis)
    if cfg.max_mito_percent < 100.0 and n_genes > 0:
        mt_rows = cell_calling.mito_gene_rows(
            [d.id for d in features.feature_defs[:n_genes]])
        cells_idx, mito_removed, _pct = cell_calling.apply_mito_filter(
            raw.m[:n_genes] if fb_ref is not None else raw.m, cells_idx,
            mt_rows, cfg.max_mito_percent)
        call_metrics["cells_removed_mito_filter"] = int(len(mito_removed))
    filtered = raw.select_barcodes(cells_idx)
    filtered.save_h5(os.path.join(out_dir, "filtered_feature_bc_matrix.h5"),
                     chemistry_description=chem.description)
    filtered.save_mex(os.path.join(out_dir, "filtered_feature_bc_matrix"))

    perf.lap("cell_calling")

    # ---- BAM output ----
    # (UB tags and low-support flags join against the raw-triple views of
    # EVERY dedup partition — the r1 last-partition-only fallback is gone)
    if bam_collector is not None:
        bam_collector.write(
            os.path.join(out_dir, "possorted_genome_bam.bam"),
            raw_views or {}, chem.barcode_length, chem.umi_length,
            gem_group=cfg.gem_group)
        if bam_collector.sibling_dirs:
            import shutil as _shutil
            _shutil.rmtree(os.path.join(out_dir, "_bam_spool"),
                           ignore_errors=True)

    # ---- splice junction table (STAR SJ.out.tab analog) ----
    if sj_counts and gi is not None:
        agg: dict = {}
        for (d, a, _s, annot), c in sj_counts.items():
            k = (d, a)
            prev = agg.get(k, (0, 0))
            agg[k] = (prev[0] + c, max(prev[1], annot))
        with open(os.path.join(out_dir, "junctions.tsv"), "w") as f:
            f.write("chrom\tintron_first\tintron_last\tstrand\tmotif\t"
                    "annotated\tunique_reads\n")
            for (d, a) in sorted(agg):
                c, annot = agg[(d, a)]
                ci = int(np.searchsorted(gi.chrom_starts, d, side="right") - 1)
                c0 = int(gi.chrom_starts[ci])
                t = gi.text
                d0, d1 = int(t[d]), int(t[d + 1]) if d + 1 < len(t) else -1
                a0 = int(t[a - 2]) if a >= 2 else -1
                a1 = int(t[a - 1]) if a >= 1 else -1
                if (d0, d1, a0, a1) == (2, 3, 0, 2):     # GT..AG
                    strand_c, motif = "+", 1
                elif (d0, d1, a0, a1) == (1, 3, 0, 1):   # CT..AC
                    strand_c, motif = "-", 2
                else:
                    strand_c, motif = ".", 0
                f.write(f"{gi.chrom_names[ci]}\t{d - c0 + 1}\t{a - c0}\t"
                        f"{strand_c}\t{motif}\t{annot}\t{c}\n")

    # ---- molecule_info.h5 ----
    # real per-molecule library index, threaded from spill time through
    # dedup in the gene column's high bits (molecule_counter.py:90-104)
    library_info = [
        {"library_type": lib.library_type, "library_id": str(i),
         "gem_group": cfg.gem_group}
        for i, lib in enumerate(libraries)]
    save_molecule_info(
        os.path.join(out_dir, "molecule_info.h5"),
        barcode_idx=mbc, feature_idx=mgene, umi=mumi, count=mreads,
        library_idx=mlib, library_info=library_info,
        barcodes=barcodes, features=features, gem_group=cfg.gem_group,
        pass_filter_bc_idx=np.asarray(cells_idx, np.uint64),
        metrics={"total_reads": metrics.total_reads,
                 "usable_read_pairs": metrics.usable_reads,
                 "chemistry": cfg.chemistry, "sample_id": cfg.sample_id})

    perf.lap("bam_junctions_molinfo")

    # ---- barnyard GEM classification (multi-genome references) ----
    if ref is not None and len(ref.genomes) > 1 and len(cells_idx):
        from ..analysis.multigenome import classify_gems
        genome_per_gene = ref.genome_of_gene()
        per_genome_counts = np.zeros((len(cells_idx), len(ref.genomes)))
        fm = filtered.m
        for gidx, gname in enumerate(ref.genomes):
            rows = [i for i, gn in enumerate(genome_per_gene) if gn == gname]
            per_genome_counts[:, gidx] = np.asarray(
                fm[rows, :].sum(axis=0)).ravel()
        calls, mg_summary = classify_gems(per_genome_counts, ref.genomes)
        with open(os.path.join(out_dir, "gem_classification.csv"), "w") as f:
            f.write("barcode," + ",".join(ref.genomes) + ",call\n")
            for i, b in enumerate(filtered.barcodes):
                f.write(b.decode() + "," + ",".join(
                    str(int(x)) for x in per_genome_counts[i]) +
                    f",{calls[i]}\n")
        call_metrics.update({f"multigenome_{k}": v
                             for k, v in mg_summary.items()})

    # ---- CRISPR / antigen feature assignment on called cells ----
    # (feature_assigner.py analog; CMO tags go through JIBES in demux)
    if fb_ref is not None and len(cells_idx):
        from ..analysis.feature_assigner import run_feature_assignment
        for ftype, sub, prefix in (
                ("CRISPR Guide Capture", "crispr_analysis", "protospacer"),
                ("Antigen Capture", "antigen_analysis", "antigen")):
            fa = run_feature_assignment(
                filtered, ftype, os.path.join(out_dir, sub), prefix)
            call_metrics.update(fa)

    # ---- secondary analysis (SC_RNA_ANALYZER analog) ----
    if cfg.secondary_analysis and len(cells_idx) >= 2:
        from ..analysis.run import run_secondary_analysis
        run_secondary_analysis(filtered, os.path.join(out_dir, "analysis"))

    perf.lap("analysis_reporting")

    # ---- summary metrics ----
    bc_space = whitelist.size * n_probe
    cell_mask = np.zeros(bc_space, bool)
    cell_mask[cells_idx] = True
    in_cell = cell_mask[mbc]
    umis_in_cells = raw.counts_per_bc()[cells_idx]
    genes_per_cell = np.asarray((filtered.m > 0).sum(axis=0)).ravel()
    extra = dict(call_metrics)
    extra.update({
        "estimated_cells": int(len(cells_idx)),
        "mean_reads_per_cell": float(metrics.total_reads / max(len(cells_idx), 1)),
        "median_umis_per_cell": float(np.median(umis_in_cells)) if len(cells_idx) else 0.0,
        "median_genes_per_cell": float(np.median(genes_per_cell)) if len(cells_idx) else 0.0,
        "total_genes_detected": int((raw.counts_per_feature() > 0).sum()),
        "reads_in_cells_frac": float(mreads[in_cell].sum() / max(mreads.sum(), 1)),
        "wall_time_s": time.time() - t0,
        "sample_id": cfg.sample_id,
        "chemistry": cfg.chemistry,
    })
    perf.lap("report_summary")
    # depth-subsampling curves (SUBSAMPLE_READS analog)
    if len(mbc):
        from ..analysis.subsample import subsample_metrics
        ss = subsample_metrics(mbc, mgene, mreads, cells_idx)
        extra.update({k: v for k, v in ss.items() if k != "curves"})
        extra["subsample_curves"] = {str(r): c
                                     for r, c in ss["curves"].items()}
    perf.lap("report_subsample")

    # mergeable histogram metrics (metric crate SimpleHistogram analog)
    from ..metrics import SimpleHistogram
    h_rpm = SimpleHistogram()
    if len(mreads):
        h_rpm.observe_array(mreads)
    extra["reads_per_molecule_hist"] = {
        int(k): int(v) for k, v in h_rpm.report().items()}
    if len(cells_idx):
        h_upc = SimpleHistogram()
        h_upc.observe_array(umis_in_cells)
        extra["umis_per_cell_p50"] = int(h_upc.quantile(0.5))
        extra["umis_per_cell_p90"] = int(h_upc.quantile(0.9))
    if probe_set is not None:
        # per-probe-region usable read tallies (targeted/RTL metrics,
        # cellranger/targeted semantics)
        extra.update({f"probe_reads_{nm}": int(c) for nm, c in
                      zip(probe_region_names, probe_region_reads)})
    summary = metrics.to_dict(extra)
    with open(os.path.join(out_dir, "metrics_summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)

    # per-barcode metrics (COLLATE_METRICS analog: per_barcode_metrics.csv)
    if len(mbc):
        reads_per_bc = np.zeros(bc_space, np.int64)
        np.add.at(reads_per_bc, mbc, mreads)
        genes_per_bc_all = np.asarray((raw.m > 0).sum(axis=0)).ravel()
        with open(os.path.join(out_dir, "per_barcode_metrics.csv"), "w") as f:
            f.write("barcode,is_cell,reads,umis,genes\n")
            for ci in np.flatnonzero(umis_per_bc):
                f.write(f"{barcodes[ci].decode()},{int(cell_mask[ci])},"
                        f"{reads_per_bc[ci]},{int(umis_per_bc[ci])},"
                        f"{genes_per_bc_all[ci]}\n")

    perf.lap("report_per_barcode")
    # filtered barcodes csv (reference: filtered_barcodes.csv)
    genome_name = ref.genome_name if ref is not None else \
        (probe_set.metadata.get("reference_genome", "probe")
         if probe_set else "genome")
    with open(os.path.join(out_dir, "filtered_barcodes.csv"), "w") as f:
        for b in filtered.barcodes:
            f.write(genome_name + "," + b.decode() + "\n")

    # web summary (MULTI_REPORTER analog)
    from .websummary import build_web_summary
    build_web_summary(out_dir, cfg.sample_id)
    perf.lap("report_websummary")

    # per-phase perf trace (pipestance _perf analog, perf.py)
    perf.lap("reporting")
    perf.write(os.path.join(out_dir, "_perf.json"))
    return summary
