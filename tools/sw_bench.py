"""Banded SW on the GPU: the plain `lax` form against the Pallas Triton form.

    python tools/sw_bench.py [--reps 20]

Times both forms alone on C = 8192 rescue-shaped reads (read length 91),
then inside the primary fused step (20 Mb genome, 100k whitelist, batch
32768), which compacts B/4 = 8192 reads into the rescue. Forms run in turns
(lax, triton, triton, lax) in one process; each time is the median of
`--reps` calls ended by block_until_ready. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def median_ms(fn, args, reps: int) -> float:
    import jax
    jax.block_until_ready(fn(*args))            # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tiles", default="32,64,128")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from cellranger_tpu.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        sys.exit("sw_bench measures on a GPU")
    enable_compile_cache()
    import bench
    import chip_smoke
    from cellranger_tpu.align import sw
    from cellranger_tpu.align.aligner import DeviceIndex
    from cellranger_tpu.align.annotate import AnnotationIndex
    from cellranger_tpu.align.index import GenomeIndex
    from cellranger_tpu.io.chemistry import get_chemistry
    from cellranger_tpu.pipeline.count import _make_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    res = {"card": card, "device_kind": jax.devices()[0].device_kind}

    # ---- alone at C = 8192 ----
    cases = tuple(jnp.asarray(a) for a in chip_smoke.sw_cases(8192, 91))
    forms = {"lax": sw.banded_sw}
    for t in (int(x) for x in args.tiles.split(",")):
        forms[f"triton_t{t}"] = (
            lambda *a, t=t: sw.banded_sw_triton(*a, tile=t,
                                                num_warps=max(t // 32, 1)))
    ref = [np.asarray(x) for x in sw.banded_sw(*cases)]
    alone = {}
    order = list(forms) + list(reversed(forms))
    for name in order:
        out = [np.asarray(x) for x in forms[name](*cases)]
        assert all(np.array_equal(a, b) for a, b in zip(out, ref)), name
        alone.setdefault(name, []).append(median_ms(forms[name], cases,
                                                    args.reps))
    res["alone_ms_C8192"] = alone
    best = min((k for k in alone if k != "lax"),
               key=lambda k: np.mean(alone[k]))
    res["best_triton"] = best

    # ---- inside the primary fused step ----
    chem = get_chemistry("SC3Pv3")
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    codes = rng.integers(0, 4, bench.GENOME_LEN).astype(np.uint8)
    txome = bench.txome_of(bench.GENOME_LEN, 2000)
    wl = np.sort(np.unique(rng.integers(0, 2**32, bench.N_WL,
                                        dtype=np.uint64).astype(np.uint32)))
    gi = GenomeIndex.build({"chr1": bases[codes].tobytes()}, txome)
    didx = DeviceIndex.from_host(gi)
    ann = AnnotationIndex.build(txome, gi)
    buf, _ = bench._make_batch(rng, codes, wl, bench.BATCH, chem)
    chosen = sw.rescue_sw
    steps = {}
    for name, fn in (("lax", sw.banded_sw), (best, forms[best])):
        sw.rescue_sw = fn           # the aligner resolves it at trace time
        steps[name] = _make_step(didx, ann, chem, bench.READ_LEN)
        jax.block_until_ready(steps[name](buf))
    sw.rescue_sw = chosen
    a = jax.tree.map(np.asarray, steps["lax"](buf))
    b = jax.tree.map(np.asarray, steps[best](buf))
    assert all(np.array_equal(a[k], b[k]) for k in a), "step outputs differ"
    in_step = {}
    for name in ("lax", best, best, "lax"):
        in_step.setdefault(name, []).append(
            median_ms(steps[name], (buf,), args.reps))
    res["step_ms_B32768"] = in_step
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
