"""Bounded-memory scale proof: generate an N-million-read synthetic run
and push it through the PRODUCTION run_count, reporting wall clock,
steady-state reads/s, per-phase times, and peak RSS.

The r1 engine cached every decoded batch in host RAM, so runs of this size
were impossible (VERDICT r1 item 2).  The streaming engine re-streams
FASTQs in pass 2 and spills molecule rows to barcode-hash partitions, so
peak RSS stays O(batch + dedup partition) regardless of N.

Usage:  python tools/big_run.py [n_million_reads] [out_dir]
FASTQ generation is vectorized numpy (~1M reads/s) into UNCOMPRESSED
.fastq so generation doesn't dominate.
"""

import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

READ_LEN = 91
BC_LEN, UMI_LEN = 16, 12


def gen_fastqs(tmp: str, n_reads: int, genome: bytes, wl: list,
               n_cells: int = 4000, chunk: int = 1 << 19):
    """Vectorized synthetic FASTQ generation: cells draw reads uniformly
    from the genome; barcodes cycle over the first n_cells whitelist
    entries."""
    rng = np.random.default_rng(123)
    garr = np.frombuffer(genome, np.uint8)
    G = len(garr)
    wl_arr = np.asarray([list(w.encode()) for w in wl[:n_cells]], np.uint8)
    r1p = os.path.join(tmp, "big_S1_L001_R1_001.fastq")
    r2p = os.path.join(tmp, "big_S1_L001_R2_001.fastq")
    bases = np.frombuffer(b"ACGT", np.uint8)
    t0 = time.time()
    with open(r1p, "wb") as f1, open(r2p, "wb") as f2:
        done = 0
        while done < n_reads:
            n = min(chunk, n_reads - done)
            bc = wl_arr[rng.integers(0, len(wl_arr), n)]
            umi = bases[rng.integers(0, 4, (n, UMI_LEN))]
            pos = rng.integers(0, G - READ_LEN, n)
            cdna = garr[pos[:, None] + np.arange(READ_LEN)[None, :]]
            # R1 lines: @rN \n bc+umi \n + \n qual \n  — build as a byte
            # matrix with fixed-width names for pure-numpy assembly
            def block(seqmat, qual_ch=b"F"):
                n_, w = seqmat.shape
                name = np.frombuffer(b"@readxxxxxxxxxx\n", np.uint8)
                rows = np.empty((n_, len(name) + w + 1 + 2 + w + 1),
                                np.uint8)
                rows[:, :len(name)] = name
                rows[:, len(name):len(name) + w] = seqmat
                o = len(name) + w
                rows[:, o] = ord("\n")
                rows[:, o + 1] = ord("+")
                rows[:, o + 2] = ord("\n")
                rows[:, o + 3:o + 3 + w] = qual_ch[0]
                rows[:, -1] = ord("\n")
                return rows.tobytes()

            f1.write(block(np.concatenate([bc, umi], axis=1)))
            f2.write(block(cdna))
            done += n
    rate = n_reads / (time.time() - t0)
    print(f"generated {n_reads} reads in {time.time()-t0:.0f}s "
          f"({rate/1e6:.2f}M reads/s)", file=sys.stderr)
    return r1p, r2p


def main():
    n_million = float(sys.argv[1]) if len(sys.argv) > 1 else 5.0
    import tempfile
    tmp = sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp(
        prefix="cr_tpu_big_")
    os.makedirs(tmp, exist_ok=True)
    n_reads = int(n_million * 1e6)

    from cellranger_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    from cellranger_tpu.io.gtf import write_fasta
    from cellranger_tpu.io.reference import ReferencePackage
    from cellranger_tpu.pipeline.count import CountConfig, run_count

    rng = np.random.default_rng(7)
    G = 20_000_000
    genome = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, G)].tobytes()
    ref_done = os.path.exists(os.path.join(tmp, "ref", "index.npz"))
    if not ref_done:
        write_fasta(os.path.join(tmp, "g.fa"), {"chr1": genome})
        with open(os.path.join(tmp, "g.gtf"), "w") as f:
            sp = G // 2000
            for g in range(2000):
                st = g * sp + 1000
                s = "+" if g % 2 == 0 else "-"
                f.write(f'chr1\tx\texon\t{st+1}\t{st+2400}\t.\t{s}\t.\t'
                        f'gene_id "G{g}"; transcript_id "T{g}"; '
                        f'gene_name "G{g}";\n')
        print("building reference...", file=sys.stderr)
        ReferencePackage.build(os.path.join(tmp, "g.fa"),
                               os.path.join(tmp, "g.gtf"),
                               os.path.join(tmp, "ref"))
    wl = sorted({"".join(rng.choice(list("ACGT"), BC_LEN))
                 for _ in range(120_000)})[:100_000]
    if not os.path.exists(os.path.join(tmp, "wl.txt")):
        with open(os.path.join(tmp, "wl.txt"), "w") as f:
            f.writelines(w + "\n" for w in wl)

    r1p = os.path.join(tmp, "big_S1_L001_R1_001.fastq")
    r2p = os.path.join(tmp, "big_S1_L001_R2_001.fastq")
    expect_r2 = n_reads * (16 + READ_LEN * 2 + 4)
    if not (os.path.exists(r2p) and os.path.getsize(r2p) == expect_r2):
        r1p, r2p = gen_fastqs(tmp, n_reads, genome, wl)
    else:
        print("reusing existing fixture", file=sys.stderr)

    cfg = CountConfig(
        fastq_pairs=[(r1p, r2p)], reference_path=os.path.join(tmp, "ref"),
        whitelist_path=os.path.join(tmp, "wl.txt"), chemistry="SC3Pv3",
        read_len=READ_LEN, batch_size=32768,
        secondary_analysis=False, checkpoint=False)
    print(f"running run_count on {n_reads} reads...", file=sys.stderr)
    t0 = time.time()
    summary = run_count(cfg, os.path.join(tmp, "out"))
    wall = time.time() - t0
    peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    with open(os.path.join(tmp, "out", "_perf.json")) as f:
        phases = json.load(f)["phases"]
    agg: dict = {}
    for ph in phases:
        agg[ph["name"]] = round(agg.get(ph["name"], 0) + ph["wall_s"], 1)
    print(json.dumps(dict(
        reads=n_reads, wall_s=round(wall, 1),
        reads_per_sec=round(n_reads / wall, 1),
        peak_rss_mb=round(peak_rss_mb, 1),
        total_molecules=summary["total_molecules"],
        conf_mapped_frac=round(summary["conf_mapped_frac"], 4),
        phase_s=agg)))


if __name__ == "__main__":
    main()
