"""Cross-chip barcode shuffle + sharded dedup — the shardio analog.

The reference moves barcode-sorted records between stages through sorted
shard files on a shared filesystem (SURVEY §2.7 P2/P3: ShardWriter/
make_chunks). On a device mesh the same logical operation is an all_to_all:
each chip routes its conf-mapped molecule rows to the chip that owns the
barcode (bc % n_chips), then runs the standard sorted-segment dedup on its
received set. Barcode ownership makes per-chip dedup globally correct —
every read of a barcode lands on one chip, exactly like an ALIGN_AND_COUNT
chunk owning a barcode range (align_and_count.rs:518-524).

all_to_all needs equal-sized splits, so rows bucket into fixed-capacity
slots per destination (invalid rows pad); capacity overflow is detected and
reported (callers retry with higher slack — the analog of shardio chunking
by read mass).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.dedup import dedup_molecules
from ..ops.scan import cummax


def make_sharded_dedup(mesh: Mesh, n_rows_per_chip: int, umi_len: int,
                       axis: str = "data", slack: float = 2.0):
    """Build a jitted sharded dedup over the mesh.

    Inputs are [n_chips * n_rows_per_chip] arrays sharded on dim 0; output
    molecule tables stay sharded (each chip owns bc % n_chips == its index).
    Capacity per (src, dst) bucket = ceil(n_rows_per_chip / n_chips * slack).
    Returns fn(bc, gene, umi, valid) -> dict of sharded arrays + overflow
    counter (scalar, per-run; >0 means slack was too small).
    """
    n = mesh.devices.size
    cap = int(np.ceil(n_rows_per_chip / n * slack))

    def local(bc, gene, umi, valid):
        me = jax.lax.axis_index(axis)
        dst = (bc % n).astype(jnp.int32)
        dst = jnp.where(valid, dst, n)  # invalid rows -> no destination
        # stable sort rows by destination, then slot them into fixed buckets
        order = jnp.argsort(dst, stable=True)
        dst_s = dst[order]
        bc_s, gene_s, umi_s = bc[order], gene[order], umi[order]
        # rank within destination group
        pos_i = jnp.arange(dst.shape[0], dtype=jnp.int32)
        new_g = jnp.concatenate([jnp.ones(1, bool), dst_s[1:] != dst_s[:-1]])
        gstart = cummax(jnp.where(new_g, pos_i, 0))
        rank = pos_i - gstart
        ok = (rank < cap) & (dst_s < n)
        overflow = jnp.sum(((rank >= cap) & (dst_s < n)).astype(jnp.int32))
        slot = jnp.where(ok, dst_s * cap + rank, n * cap)  # n*cap = trash row

        def scatter(x, fill):
            buf = jnp.full((n * cap + 1,), fill, x.dtype)
            return buf.at[slot].set(jnp.where(ok, x, fill))[:-1]

        b_bc = scatter(bc_s, jnp.uint32(0)).reshape(n, cap)
        b_gene = scatter(gene_s, jnp.uint32(0)).reshape(n, cap)
        b_umi = scatter(umi_s, jnp.uint32(0)).reshape(n, cap)
        b_val = scatter(ok.astype(jnp.uint32), jnp.uint32(0)).reshape(n, cap)

        # exchange bucket d of chip s -> chip d
        t_bc = jax.lax.all_to_all(b_bc, axis, 0, 0, tiled=False)
        t_gene = jax.lax.all_to_all(b_gene, axis, 0, 0, tiled=False)
        t_umi = jax.lax.all_to_all(b_umi, axis, 0, 0, tiled=False)
        t_val = jax.lax.all_to_all(b_val, axis, 0, 0, tiled=False)

        rb = t_bc.reshape(-1)
        rg = t_gene.reshape(-1)
        ru = t_umi.reshape(-1)
        rv = t_val.reshape(-1) > 0
        dd = dedup_molecules(rb, rg, ru, rv, umi_len)
        # scalars become per-chip length-1 vectors so they shard on the axis
        dd["n_molecules"] = dd["n_molecules"][None]
        dd["overflow"] = overflow[None]
        return dd

    specs_in = (P(axis),) * 4
    out_spec = dict(
        mol_bc=P(axis), mol_gene=P(axis), mol_umi=P(axis),
        mol_reads=P(axis), mol_valid=P(axis), n_molecules=P(axis),
        raw_bc=P(axis), raw_gene=P(axis), raw_umi=P(axis),
        raw_corr_umi=P(axis), raw_low=P(axis), raw_is_repr=P(axis),
        raw_reads=P(axis), overflow=P(axis),
    )
    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=specs_in,
                                 out_specs=out_spec, check_vma=False))
