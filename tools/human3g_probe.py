"""GRCh38-scale reality probe (VERDICT r3 item 3): build the index for a
3.1GB synthetic genome + ~250k-exon transcriptome and measure what the
reference documents for its STAR index (reference_builder.py:167,404 —
"16GB-class index, 8+ core-hours for a 3Gb genome"):

  * host index build wall time + peak RSS,
  * .npz cache size,
  * DeviceIndex HBM budget (text_rows + kmer table + annotation tables),
  * (when a device is reachable and --step is passed) single-chip step
    reads/s at batch 8192.

The genome is 24 chromosomes of repeat-seeded random sequence (5% of the
text is a 4-copy repeat family — multimapper pressure like the human
genome's segmental duplications).

Usage: python tools/human3g_probe.py [out_json] [--step]
(the result is printed as one JSON line, and also written to out_json
when one is given)
"""

import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

GENOME_LEN = 3_100_000_000
N_CHROM = 24
N_GENES = 21_000
EXONS_PER_GENE = 12        # ~252k exons
REPEAT_LEN = 40_000_000    # one 40MB family x 4 copies = 5% of the text
REPEAT_COPIES = 4
READ_LEN = 91
BATCH = 8192


def main():
    out_json = sys.argv[1] if len(sys.argv) > 1 and not \
        sys.argv[1].startswith("--") else None
    do_step = "--step" in sys.argv

    from cellranger_tpu.align.index import GenomeIndex
    from cellranger_tpu.io.gtf import Gene, Transcript, Transcriptome

    rng = np.random.default_rng(42)
    print("generating 3.1GB genome...", file=sys.stderr, flush=True)
    t0 = time.time()
    clen = GENOME_LEN // N_CHROM
    rep = rng.integers(0, 4, REPEAT_LEN, dtype=np.int8).astype(np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = {}
    for c in range(N_CHROM):
        codes = rng.integers(0, 4, clen, dtype=np.int8).astype(np.uint8)
        if c < REPEAT_COPIES:   # one repeat copy at the start of chr1..4
            codes[:REPEAT_LEN] = rep
        seqs[f"chr{c + 1}"] = bases[codes].tobytes()
    del rep
    t_gen = time.time() - t0
    print(f"genome generated in {t_gen:.0f}s", file=sys.stderr, flush=True)

    genes, txs = [], []
    spacing = clen // (N_GENES // N_CHROM + 1)
    gidx = 0
    for c in range(N_CHROM):
        for g in range(N_GENES // N_CHROM):
            start = g * spacing + 100_000
            strand = "+" if gidx % 2 == 0 else "-"
            exons = [(start + e * 3000, start + e * 3000 + 400)
                     for e in range(EXONS_PER_GENE)]
            genes.append(Gene(f"G{gidx}", f"G{gidx}", f"chr{c + 1}",
                              strand, gidx))
            txs.append(Transcript(f"T{gidx}", gidx, f"chr{c + 1}",
                                  strand, exons))
            gidx += 1
    txome = Transcriptome(genes, txs)
    n_junctions = sum(len(t.exons) - 1 for t in txs)
    print(f"transcriptome: {gidx} genes, {n_junctions} junctions",
          file=sys.stderr, flush=True)

    t0 = time.time()
    gi = GenomeIndex.build(seqs, txome)
    t_build = time.time() - t0
    peak_rss_gb = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"index built in {t_build:.0f}s, peak RSS {peak_rss_gb:.1f}GB",
          file=sys.stderr, flush=True)

    # HBM budget (DeviceIndex layout, aligner.py:75-88 + bucket_table):
    # computed host-side so no device is needed
    from cellranger_tpu.ops.bucket_table import BucketTable
    t0 = time.time()
    kt = BucketTable.build(gi.kmer_keys, gi.kmer_pos, entries=8, fields=2)
    t_table = time.time() - t0
    text_rows_b = (len(gi.text) // 256 + 2) * 32 * 4   # [NR+2, 32] u32
    kt_b = int(np.prod(kt.rows.shape)) * 4
    ann_rows = 2 * len(txs) * EXONS_PER_GENE
    ann_b = ann_rows * 4 * 4                  # interval tables (approx)
    hbm = dict(text_rows_gb=round(text_rows_b / 1e9, 2),
               kmer_table_gb=round(kt_b / 1e9, 2),
               annotation_gb=round(ann_b / 1e9, 3),
               total_gb=round((text_rows_b + kt_b + ann_b) / 1e9, 2),
               kmer_entries=int(len(gi.kmer_keys)),
               bucket_probe_rows=int(kt.probe_rows))

    cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".bench_cache")
    os.makedirs(cache, exist_ok=True)
    npz = os.path.join(cache, "human3g_idx.npz")
    t0 = time.time()
    gi.save(npz)
    t_save = time.time() - t0
    npz_gb = os.path.getsize(npz) / 1e9

    result = dict(
        genome_len=GENOME_LEN, genes=gidx, junctions=n_junctions,
        sampling=gi.sampling, pos_mode=gi.pos_mode,
        minimizer_w=gi.minimizer_w,
        genome_gen_s=round(t_gen, 1),
        index_build_s=round(t_build, 1),
        bucket_table_build_s=round(t_table, 1),
        npz_save_s=round(t_save, 1), npz_gb=round(npz_gb, 2),
        peak_rss_gb=round(peak_rss_gb, 1),
        hbm=hbm,
        reference_comparison=dict(
            star_grch38="~16GB index RAM, 8+ core-hours to build "
                        "(reference_builder.py:167,404)"))

    if do_step:
        import jax
        from cellranger_tpu.compile_cache import enable_compile_cache
        enable_compile_cache()
        from cellranger_tpu.align.aligner import DeviceIndex
        from cellranger_tpu.align.annotate import AnnotationIndex
        from cellranger_tpu.io.chemistry import get_chemistry
        from cellranger_tpu.pipeline.count import _make_step, \
            pack_step_input
        from types import SimpleNamespace
        t0 = time.time()
        didx = DeviceIndex.from_host(gi)
        ann = AnnotationIndex.build(txome, gi)
        t_xfer = time.time() - t0
        chem = get_chemistry("SC3Pv3")
        step = _make_step(didx, ann, chem, READ_LEN)
        # reads from the text (2-bit codes are gi.text directly)
        pos = rng.integers(0, gi.genome_len - READ_LEN - 1, BATCH)
        rna = gi.text[pos[:, None] + np.arange(READ_LEN)[None, :]] \
            .astype(np.uint8)
        shim = SimpleNamespace(
            batch_size=BATCH,
            umi_packed=rng.integers(0, 1 << 24, BATCH).astype(np.uint32),
            slot_valid=np.ones(BATCH, bool),
            umi_valid=np.ones(BATCH, bool), rna=rna,
            rna_nmask=np.ones((BATCH, READ_LEN), bool),
            rna2=None, rna2_nmask=None)
        buf = pack_step_input(chem, READ_LEN, shim,
                              rng.integers(0, 1 << 20, BATCH)
                              .astype(np.int32))
        t0 = time.time()
        out = step(buf)
        jax.block_until_ready(out["i32"])
        t_compile = time.time() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            for _ in range(3):
                out = step(buf)
            jax.block_until_ready(out["i32"])
            best = min(best, (time.time() - t0) / 3)
        result["step"] = dict(
            device_upload_s=round(t_xfer, 1),
            compile_s=round(t_compile, 1),
            step_ms=round(best * 1e3, 2),
            reads_per_sec=round(BATCH / best, 1), batch=BATCH)

    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
