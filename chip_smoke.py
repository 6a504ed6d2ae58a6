#!/usr/bin/env python3
"""Smoke test of the `count` path on one GPU.

    python chip_smoke.py                 # phases 1-6 on one card
    python chip_smoke.py --phases 1,2,3  # a subset (phase 1 always runs)
    python chip_smoke.py --chips 4       # the 4-card mesh path only

Phases, each of which must pass (nothing here catches a failure):
  1. device and host: the platform is a GPU; card name and power limit,
     JAX version, h5py and the native FASTQ reader;
  2. banded SW parity at read length 91 against `sw_traceback_host`;
  3. the primary fused step (20 Mb genome, 100k whitelist, batch 32768),
     and the step over a small minimizer/parity index, on the GPU against
     the same jitted step on the CPU device, byte for byte, with each
     step's compiled memory analysis;
  4. the two golden fixtures through `run_count` (BAM on), compared with
     tests/golden/e2e{,_rich} by the repo's conformance comparators;
  5. the bench's 1M-read e2e fixture through `run_count`: count-only (cold,
     then warm), then BAM + secondary analysis, checked against its truth,
     and PCA / k-means / graph clustering on the GPU against the CPU device;
  6. the human-scale minimizer/parity index (280 Mb, 3M whitelist): one
     batch of 32768 and the truth probe.
With --chips 4 it runs phase 1 and then only the mesh path: run_count over a
4-device mesh, replicated and with the k-mer table sharded, byte-compared
against a one-card run in the same process.

The last stdout line is one JSON object
{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}; it is
printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SW_READS = 4100          # >= 4096 reads, not a multiple of the Triton tile
READ_LEN = 91


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(n: int, title: str):
    def deco(fn):
        def run(*a, **kw):
            log(f"== phase {n}: {title}")
            t0 = time.time()
            out = fn(*a, **kw)
            log(f"== phase {n} passed ({time.time() - t0:.1f}s)")
            return out
        return run
    return deco


# ----------------------------------------------------------------- phase 1
@phase(1, "device and host")
def device_and_host():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX found {dev.platform} ({dev.device_kind})")
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"device_kind: {dev.device_kind}; devices: {len(jax.devices())}")
    log(f"nvidia-smi name, power.limit: {smi}")
    log(f"jax {jax.__version__}; python {sys.version.split()[0]}")
    try:
        import h5py
        log(f"h5py: {h5py.__version__}")
    except ImportError:
        log("h5py: not installed")
    from cellranger_tpu import native
    log("native FASTQ reader: "
        + ("loaded" if native.get_lib() is not None else "NOT loaded"))


# ----------------------------------------------------------------- phase 2
def sw_cases(n: int, L: int, seed: int = 0):
    """Seeded rescue-shaped cases: each read is a window slice with
    substitutions, a 1-3 base insertion or deletion, and masked tails."""
    from cellranger_tpu.align.sw import BAND

    rng = np.random.default_rng(seed)
    W = L + BAND
    win = rng.integers(0, 4, (n, W)).astype(np.uint8)
    read = np.empty((n, L), np.uint8)
    for b in range(n):
        off = int(rng.integers(2, BAND - 4))
        frag = list(win[b, off:])
        for p in rng.integers(0, L, int(rng.integers(0, 6))):
            frag[p] = int(rng.integers(0, 4))
        k = int(rng.integers(1, 4))
        p = int(rng.integers(10, L - 10))
        if b % 3 == 1:
            del frag[p:p + k]
        elif b % 3 == 2:
            frag[p:p] = list(rng.integers(0, 4, k))
        frag += list(rng.integers(0, 4, L))
        read[b] = frag[:L]
    rmask = np.ones((n, L), bool)
    wmask = np.ones((n, W), bool)
    for b in range(0, n, 5):
        rmask[b, int(rng.integers(L // 2, L)):] = False
    for b in range(2, n, 7):
        wmask[b, int(rng.integers(L // 2, W)):] = False
    rmask[n - 1] = False                      # one all-masked read
    return read, rmask, win, wmask


@phase(2, "banded SW parity against the host reference")
def sw_parity():
    import jax.numpy as jnp
    from cellranger_tpu.align import sw

    read, rmask, win, wmask = sw_cases(SW_READS, READ_LEN)
    t0 = time.time()
    ref = np.asarray([sw.sw_traceback_host(read[b], rmask[b], win[b],
                                           wmask[b])[0]
                      for b in range(SW_READS)])
    log(f"host reference: {SW_READS} reads in {time.time() - t0:.1f}s; "
        f"{int((ref > 0).sum())} with a positive score")
    args = tuple(jnp.asarray(a) for a in (read, rmask, win, wmask))
    forms = {"banded_sw": sw.banded_sw}
    if hasattr(sw, "banded_sw_triton"):
        forms["banded_sw_triton"] = sw.banded_sw_triton
    first = None
    for name, fn in forms.items():
        out = [np.asarray(x) for x in fn(*args)]
        n_bad = int((out[0] != ref).sum())
        log(f"{name}: score mismatches vs host {n_bad}/{SW_READS}")
        assert n_bad == 0, name
        if first is None:
            first = out
        for a, b, what in zip(out, first, ("score", "end_i", "end_d")):
            assert np.array_equal(a, b), f"{name} {what} differs"


# ----------------------------------------------------------------- phase 3
def _step_gpu_vs_cpu(step, buf, label: str) -> dict:
    """Run one jitted step on the GPU and on the CPU device; the packed
    planes must match byte for byte. Returns the GPU metrics."""
    import jax
    from cellranger_tpu.pipeline.count import METRIC_FIELDS

    args = step.bound_args + (buf,)
    t0 = time.time()
    compiled = step.impl.lower(*args).compile()
    log(f"[{label}] GPU compile {time.time() - t0:.1f}s")
    log(f"[{label}] memory_analysis: {compiled.memory_analysis()}")
    gpu = jax.tree.map(np.asarray, compiled(*args))
    cpu_args = jax.device_put(args, jax.devices("cpu")[0])
    t0 = time.time()
    cpu = jax.tree.map(np.asarray, step.impl(*cpu_args))
    log(f"[{label}] CPU step (compile + run) {time.time() - t0:.1f}s")
    for k in ("i32", "flags", "mvec"):
        assert gpu[k].shape == cpu[k].shape, k
        n_diff = int((gpu[k] != cpu[k]).sum())
        log(f"[{label}] plane {k} {gpu[k].shape}: {n_diff} differing elements")
        assert n_diff == 0, (label, k)
    m = dict(zip(METRIC_FIELDS, gpu["mvec"].tolist()))
    log(f"[{label}] metrics: {m}")
    return m


@phase(3, "fused steps, GPU against the CPU device")
def step_vs_cpu():
    import bench
    from cellranger_tpu.align.aligner import DeviceIndex
    from cellranger_tpu.align.annotate import AnnotationIndex
    from cellranger_tpu.align.index import GenomeIndex
    from cellranger_tpu.io.chemistry import get_chemistry
    from cellranger_tpu.pipeline.count import _make_step

    chem = get_chemistry("SC3Pv3")
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    codes = rng.integers(0, 4, bench.GENOME_LEN).astype(np.uint8)
    txome = bench.txome_of(bench.GENOME_LEN, 2000)
    wl = np.sort(np.unique(rng.integers(0, 2**32, bench.N_WL,
                                        dtype=np.uint64).astype(np.uint32)))
    step, t_index = bench._build_step(bases[codes].tobytes(), txome, chem)
    buf, _ = bench._make_batch(rng, codes, wl, bench.BATCH, chem)
    log(f"host index build {t_index:.1f}s")
    m = _step_gpu_vs_cpu(step, buf, "primary")
    assert m["n_mapped"] >= 0.95 * bench.BATCH, m

    # the human-scale index's modes (minimizer seeds picked by the
    # HIGHEST-precision one-hot einsum, parity position packing) on a
    # small genome, so the CPU side stays cheap
    n = 4_000_000
    gi = GenomeIndex.build({"chr1": bases[codes[:n]].tobytes()},
                           bench.txome_of(n, 400), sampling="minimizer",
                           pos_mode="parity")
    step = _make_step(DeviceIndex.from_host(gi),
                      AnnotationIndex.build(bench.txome_of(n, 400), gi),
                      chem, bench.READ_LEN)
    pos = rng.integers(0, n - bench.READ_LEN - 1, 8192)
    buf, _ = bench._make_batch(rng, codes[:n], wl, 8192, chem, pos=pos)
    m = _step_gpu_vs_cpu(step, buf, "minimizer+parity")
    assert m["n_mapped"] >= 0.95 * 8192, m


# ----------------------------------------------------------------- phase 4
def _gate(out: str, golden: str) -> None:
    from cellranger_tpu.testing import correctness as cc

    cc.assert_metrics(os.path.join(out, "metrics_summary.json"),
                      os.path.join(golden, "metrics_summary.json"))
    for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
        cc.assert_mtx(os.path.join(out, "raw_feature_bc_matrix", f),
                      os.path.join(golden, "raw_feature_bc_matrix", f))
    cc.assert_h5(os.path.join(out, "filtered_feature_bc_matrix.h5"),
                 os.path.join(golden, "filtered_feature_bc_matrix.h5"))
    cc.assert_molecule_info(os.path.join(out, "molecule_info.h5"),
                            os.path.join(golden, "molecule_info.h5"))
    cc.assert_bam(os.path.join(out, "possorted_genome_bam.bam"),
                  os.path.join(golden, "possorted_genome_bam.bam"))
    for f in ("filtered_barcodes.csv", "junctions.tsv"):
        with open(os.path.join(out, f)) as fa, \
                open(os.path.join(golden, f)) as fe:
            assert fa.read() == fe.read(), f"{f} differs from golden"


@phase(4, "golden gates through run_count")
def golden_gates(tmp: str):
    from cellranger_tpu.pipeline.count import (CountConfig, LibraryDef,
                                               run_count)
    from cellranger_tpu.testing.fixtures import (READ_LEN as FX_LEN,
                                                 build_rich_run,
                                                 build_synthetic_run)

    fx = build_synthetic_run(os.path.join(tmp, "e2e"))
    out = os.path.join(tmp, "e2e", "outs")
    s = run_count(CountConfig(
        fastq_pairs=[(fx["fq1"], fx["fq2"])], reference_path=fx["ref"],
        whitelist_path=fx["wl"], chemistry="SC3Pv3", read_len=FX_LEN,
        batch_size=4096, write_bam=True), out)
    truth = fx["truth"]
    assert s["total_molecules"] == int(truth.sum()), s["total_molecules"]
    assert s["estimated_cells"] == truth.shape[1], s["estimated_cells"]
    _gate(out, os.path.join(REPO, "tests", "golden", "e2e"))
    log(f"e2e golden gate: exact ({s['total_reads']} reads, "
        f"{s['total_molecules']} molecules)")

    fx = build_rich_run(os.path.join(tmp, "rich"))
    out = os.path.join(tmp, "rich", "outs")
    s = run_count(CountConfig(
        fastq_pairs=[], reference_path=fx["ref"], whitelist_path=fx["wl"],
        feature_ref_csv=fx["feature_ref"],
        libraries=[LibraryDef([(fx["fq1"], fx["fq2"])], "Gene Expression"),
                   LibraryDef([(fx["ab_fq1"], fx["ab_fq2"])],
                              "Antibody Capture")],
        chemistry="SC3Pv3", read_len=FX_LEN, batch_size=4096,
        write_bam=True, checkpoint=False, secondary_analysis=False), out)
    _gate(out, os.path.join(REPO, "tests", "golden", "e2e_rich"))
    log(f"e2e_rich golden gate: exact ({s['total_reads']} reads, "
        f"{s['total_molecules']} molecules)")


# ----------------------------------------------------------------- phase 5
# Molecules lost against the generated count: two molecules of one
# (cell, gene) whose UMIs are one base apart merge (expected ~0.3 at this
# size: cells*genes * lambda^2/2 * 36/4^12 with lambda = 0.625), and a
# barcode error can be corrected onto another whitelist entry (rare).
MOLECULE_DEFICIT_MAX = 50


def _phases_s(out_dir: str) -> dict:
    agg: dict = {}
    with open(os.path.join(out_dir, "_perf.json")) as f:
        for ph in json.load(f)["phases"]:
            agg[ph["name"]] = round(agg.get(ph["name"], 0) + ph["wall_s"], 3)
    return agg


def e2e_config(fx: dict, **kw):
    from cellranger_tpu.pipeline.count import CountConfig

    base = dict(fastq_pairs=[(fx["fq1"], fx["fq2"])],
                reference_path=fx["ref"], whitelist_path=fx["wl"],
                chemistry="SC3Pv3", read_len=READ_LEN, batch_size=32768,
                secondary_analysis=False, checkpoint=False)
    return CountConfig(**{**base, **kw})


def _check_truth(s: dict, fx: dict, bench) -> None:
    assert s["total_reads"] == fx["n_reads"], s["total_reads"]
    assert s["conf_mapped_frac"] >= 0.99, s["conf_mapped_frac"]
    deficit = fx["n_molecules"] - s["total_molecules"]
    assert 0 <= deficit <= MOLECULE_DEFICIT_MAX, (s["total_molecules"],
                                                   fx["n_molecules"])
    assert abs(s["estimated_cells"] - bench.E2E_CELLS) <= bench.E2E_CELLS // 50, \
        s["estimated_cells"]


@phase(5, "1M-read pipeline: count-only, then BAM + analysis")
def real_size(tmp: str):
    import jax
    import bench
    from cellranger_tpu.pipeline.count import run_count

    os.makedirs(tmp)
    t0 = time.time()
    fx = bench._gen_e2e_fixture(tmp, bench.txome_of)
    log(f"fixture: {fx['n_reads']} reads, {fx['n_molecules']} molecules "
        f"({time.time() - t0:.1f}s)")
    # count-only twice (cold: trace + compile or compile-cache load; warm:
    # steady state), then the full output surface once
    for name, rep, kw in (
            ("count-only", "cold", {}), ("count-only", "warm", {}),
            ("bam+analysis", "cold", dict(write_bam=True,
                                          secondary_analysis=True))):
        out = os.path.join(tmp, f"out_{name}_{rep}")
        t0 = time.time()
        s = run_count(e2e_config(fx, **kw), out)
        log(f"{name} {rep}: wall {time.time() - t0:.2f}s, phases "
            f"{_phases_s(out)}")
        _check_truth(s, fx, bench)
        log(f"{name}: molecules {s['total_molecules']} "
            f"(generated {fx['n_molecules']}), cells {s['estimated_cells']}, "
            f"conf_mapped {s['conf_mapped_frac']:.4f}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak device bytes: {stats.get('peak_bytes_in_use')}")
    analysis_vs_cpu(out)


def analysis_vs_cpu(out_dir: str) -> None:
    """PCA (up to sign), k-means and graph-clustering labels on the GPU
    against the same functions on the CPU device, from one filtered matrix.
    PCA's tolerance: float32 sums in another order, HIGHEST precision on
    both; labels must be equal."""
    import jax
    from cellranger_tpu.analysis.graphclust import run_graph_clustering
    from cellranger_tpu.analysis.kmeans import run_kmeans
    from cellranger_tpu.analysis.pca import run_pca
    from cellranger_tpu.analysis.preprocess import (log_normalize_dense,
                                                    select_features)
    from cellranger_tpu.io.matrix_io import CountMatrix

    mat = CountMatrix.load_h5(os.path.join(out_dir,
                                           "filtered_feature_bc_matrix.h5"))
    x = log_normalize_dense(mat.m, select_features(mat.m, 2000))
    cpu = jax.devices("cpu")[0]

    def both(fn, *a):
        g = fn(*a)
        with jax.default_device(cpu):
            c = fn(*a)
        return g, c

    pg, pc = both(run_pca, x)
    proj = pg["transformed_pca_matrix"]
    scale = np.abs(proj).max(axis=0)
    err = float((np.abs(np.abs(proj) - np.abs(pc["transformed_pca_matrix"]))
                 / scale).max())
    log(f"PCA {proj.shape}: max |GPU|-|CPU| / column scale = {err:.2e}")
    assert err <= 1e-3, err
    for k in (2, 5, 10):
        (lg, _, _), (lc, _, _) = both(run_kmeans, proj, k)
        log(f"kmeans k={k}: {int((lg != lc).sum())} labels differ")
        assert np.array_equal(lg, lc), k
    gg, gc = both(run_graph_clustering, proj)
    log(f"graphclust: {len(set(gg.tolist()))} clusters, "
        f"{int((gg != gc).sum())} labels differ")
    assert np.array_equal(gg, gc)


# ----------------------------------------------------------------- phase 6
@phase(6, "human-scale index: one batch + truth probe")
def human_scale():
    import bench
    from cellranger_tpu.io.chemistry import get_chemistry

    r = bench.bench_human_scale(get_chemistry("SC3Pv3"), bench.txome_of)
    log(f"human-scale: {json.dumps(r)}")


# ----------------------------------------------------------------- phase 7
@phase(7, "run_count over a 4-device mesh against one card")
def mesh4(tmp: str):
    import jax
    import bench
    from cellranger_tpu.io.matrix_io import CountMatrix
    from cellranger_tpu.io.molecule_info import load_molecule_info
    from cellranger_tpu.parallel.mesh import make_mesh
    from cellranger_tpu.pipeline.count import run_count

    n = len(jax.devices())
    assert n >= 4, f"--chips 4 needs 4 devices, JAX found {n}"
    fx = bench._gen_e2e_fixture(tmp, bench.txome_of)
    log(f"fixture: {fx['n_reads']} reads")
    cfg = e2e_config(fx)
    runs = {}
    # the mesh runs go first, so each device's peak memory so far is the
    # mesh's alone: a mesh that piled its work onto device 0 shows there
    for name, mesh, c in (
            ("mesh", make_mesh(4), cfg),
            ("mesh_shard_index", make_mesh(4),
             dataclasses.replace(cfg, shard_index=True)),
            ("single", None, cfg)):
        out = os.path.join(tmp, name)
        t0 = time.time()
        runs[name] = (out, run_count(c, out, mesh=mesh))
        log(f"{name}: wall {time.time() - t0:.2f}s, phases {_phases_s(out)}")
        if name == "mesh_shard_index":
            peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                     for d in jax.devices()[:4]]
            log(f"peak bytes per device after the mesh runs: {peaks}")
            assert min(peaks) >= 0.25 * max(peaks), \
                "mesh work piled onto one device"
    _check_truth(runs["single"][1], fx, bench)
    out0, s0 = runs["single"]
    m0 = CountMatrix.load_h5(os.path.join(out0, "raw_feature_bc_matrix.h5"))
    mi0 = load_molecule_info(os.path.join(out0, "molecule_info.h5"))
    for name in ("mesh", "mesh_shard_index"):
        out, s = runs[name]
        mv = CountMatrix.load_h5(os.path.join(out, "raw_feature_bc_matrix.h5"))
        assert (m0.m != mv.m).nnz == 0, f"{name}: matrix differs"
        miv = load_molecule_info(os.path.join(out, "molecule_info.h5"))
        for k in ("barcode_idx", "feature_idx", "umi", "count"):
            assert np.array_equal(mi0[k], miv[k]), f"{name}: {k} differs"
        for k, v in s0.items():
            if k != "wall_time_s":
                assert s[k] == v, f"{name}: summary[{k}] {s[k]} != {v}"
        log(f"{name}: matrix, molecule_info and summary identical to the "
            "one-card run")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--phases", default="1,2,3,4,5,6",
                    help="comma-separated phases of the one-card run")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from cellranger_tpu.compile_cache import enable_compile_cache
    import jax

    device_and_host()
    log(f"compile cache: {enable_compile_cache()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.chips == 4:
            mesh4(tmp)
        else:
            todo = {int(p) for p in args.phases.split(",")}
            if 2 in todo:
                sw_parity()
            if 3 in todo:
                step_vs_cpu()
            if 4 in todo:
                golden_gates(tmp)
            if 5 in todo:
                real_size(os.path.join(tmp, "e2e1m"))
            if 6 in todo:
                human_scale()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
