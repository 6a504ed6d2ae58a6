"""Device mesh + sharded execution of the counting step.

Replaces the reference's process/cluster parallelism (SURVEY §2.7: Martian
chunk fan-out P1, shardio barcode shuffle P2/P3, metric merge trees P5) with
a jax.sharding mesh:

  * reads are data-parallel across the `data` axis (each chip aligns its own
    batch slice against a replicated index) — the analog of one Martian
    ALIGN_AND_COUNT chunk per 15M reads;
  * the whitelist count histogram and scalar metrics are partial per chip
    and merged with psum — the analog of join()'s Metric::merge;
  * the molecule table stays sharded (each chip's conf-mapped reads), and
    the global dedup runs on re-sharded sorted keys (round 2: all_to_all by
    barcode range, the shardio shuffle analog).

Everything compiles under jit over the mesh via shard_map, so XLA inserts
the collectives; no hand-written NCCL-style communication.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def shard_batch_arrays(mesh: Mesh, arrays: dict, axis: str = "data") -> dict:
    """Place batch arrays sharded on dim 0 across the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return {k: jax.device_put(v, sharding) for k, v in arrays.items()}


def make_sharded_step(step_fn, mesh: Mesh, axis: str = "data",
                      n_batch_args: int = 1):
    """Wrap the fused count step for SPMD execution: batch dims sharded,
    metrics psummed across chips.

    n_batch_args: per-read array arguments (1 since round 3 — the packed
    uint32 input plane).  When step_fn carries `.impl`/`.bound_args`
    attributes (see count._make_step), the bound index pytrees flow
    through shard_map as REPLICATED ARGUMENTS rather than closure
    constants (closed-over arrays would be embedded in the compiled
    program, see align.aligner.DeviceIndex).
    out_specs are pytree PREFIXES (arrays -> P(axis), metrics -> P()) so
    the wrapper keeps working as the step grows new output fields."""

    impl = getattr(step_fn, "impl", step_fn)
    bound = tuple(getattr(step_fn, "bound_args", ()))
    mkey_cell = {"k": "metrics"}

    def spmd(*args):
        out = dict(impl(*args))
        mkey = "mvec" if "mvec" in out else "metrics"
        mkey_cell["k"] = mkey  # recorded at trace time (first call)
        metrics = jax.tree.map(lambda x: jax.lax.psum(x, axis),
                               out.pop(mkey))
        return out, metrics

    # bound args are replicated unless the step declares per-arg spec
    # pytrees (the sharded-index path: didx.kmer_table.rows rides P(axis),
    # parallel/index_shard.shard_device_index)
    bound_specs = getattr(step_fn, "bound_specs", None) \
        or (P(None),) * len(bound)
    in_spec = tuple(bound_specs) + (P(axis),) * n_batch_args
    fn = jax.jit(jax.shard_map(
        spmd, mesh=mesh, in_specs=in_spec, out_specs=(P(axis), P()),
        check_vma=False))

    def wrapped(*args):
        out, metrics = fn(*bound, *args)
        out = dict(out)
        out[mkey_cell["k"]] = metrics
        return out

    return wrapped


def make_sharded_part_dedup(mesh: Mesh, umi_len: int, axis: str = "data"):
    """Sharded dedup over PRE-PARTITIONED molecule rows: device i receives
    the rows of barcode-hash partition i (stacked [n*N] arrays sharded on
    dim 0), runs the sorted-segment dedup locally, and returns sharded
    outputs.  No collective is needed because the host spill already routed
    every read of a barcode to one partition (pipeline/spill.MoleculeSpill)
    — the production analog of the shardio shuffle, with disk as the
    exchange medium (SURVEY §2.7 P2/P3).  For HBM-resident runs the
    all_to_all route is parallel/shuffle.make_sharded_dedup."""
    from ..ops.dedup import dedup_molecules

    def f(bc, gene, umi, valid):
        from .executor import DD_FIELDS, _pack_dd
        dd = dedup_molecules(bc, gene, umi, valid, umi_len)
        dd.pop("n_molecules")
        return _pack_dd(dd, DD_FIELDS)  # [N, 12] int32: one fetch per device slice

    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(axis),) * 4,
                                 out_specs=P(axis), check_vma=False))


def make_sharded_bc_histogram(mesh: Mesh, wl_size: int, axis: str = "data"):
    """Sharded pass-1 whitelist counting: each chip histograms its batch
    slice, psum merges (the Metric::merge analog of MAKE_SHARD's join)."""
    from ..ops.barcode import count_valid_barcodes

    def f(idx, valid):
        h = count_valid_barcodes(idx, valid, wl_size)
        return jax.lax.psum(h, axis)

    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(axis), P(axis)),
                                 out_specs=P(), check_vma=False))
