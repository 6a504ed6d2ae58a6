"""Sharded genome kmer table: each chip owns a bucket-row range.

BASELINE config 4 ("multi-host sharded index, collective count merge") —
the capability the reference gets from mmap-sharing one full STAR index
per host (cr_lib/src/stages/align_and_count.rs:588,
reference_builder.py:167 ~16GB GRCh38): at multi-species/custom-reference
scale the kmer table outgrows one chip's HBM, so the mesh shards it by
bucket range and reads exchange SEED QUERIES with the owning chip instead
of replicating the table.

Design (the shardio-shuffle analog at seed granularity):
  * the BucketTable's row array [R, W] shards evenly over the mesh axis
    (R = 2^bits bucket rows; owner of global row h is h >> log2(R/n));
  * each chip computes its local batch's canonical seed hashes, buckets
    them by owner into fixed-capacity slots, and all_to_all's the LOCAL
    row ids [n, cap];
  * the owner gathers its rows ([n, cap, W], the only HBM touch of the
    whole exchange) and all_to_all's them straight back — position
    (src, slot) round-trips, so no index bookkeeping crosses chips;
  * the source unpacks rows back into query order and key-compares
    exactly as the local lookup does (ops/bucket_table.lookup).

Everything else in the aligner (voting, extension, text windows) stays
local: the text rows are ~0.9GB/Gbase and remain replicated, while the
kmer table (~2.8GB/Gbase) is what scales with k-mer diversity.

Capacity: queries hash uniformly, so cap = ceil(B*S/n * slack) overflows
with vanishing probability at slack 2; overflowed queries degrade to
seed misses (exactly like the per-seed hit cap) and are counted in the
returned overflow scalar.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.bucket_table import BucketTable, MIX
from ..ops.scan import cummax


def _log2(n: int) -> int:
    b = 0
    while (1 << b) < n:
        b += 1
    return b


def strip_pad_row(table: BucketTable) -> BucketTable:
    """Drop the spill pad row so the row count is the power-of-two R
    (shardable evenly).  Only valid for probe_rows=1 tables — the genome
    kmer table never probes row h+1."""
    assert table.probe_rows == 1, "sharding requires probe_rows=1"
    R = 1 << table.bits
    return BucketTable(rows=table.rows[:R], bits=table.bits,
                       entries=table.entries, fields=table.fields,
                       probe_rows=1)


def shard_device_index(didx, mesh: Mesh, axis: str = "data"):
    """Place a DeviceIndex with its kmer-table rows sharded over `axis`
    (everything else replicated).  Returns (didx', in_spec_pytree) where
    in_spec_pytree matches didx' for shard_map in_specs."""
    import dataclasses
    n = int(mesh.devices.size)
    kt = strip_pad_row(didx.kmer_table)
    assert (1 << kt.bits) % n == 0, "mesh size must divide 2^bits"
    didx2 = dataclasses.replace(didx, kmer_table=kt)
    spec = jax.tree.map(lambda _: P(), didx2)
    spec = dataclasses.replace(
        spec, kmer_table=dataclasses.replace(spec.kmer_table, rows=P(axis)))
    sharding = jax.tree.map(
        lambda s: NamedSharding(mesh, s), spec,
        is_leaf=lambda x: isinstance(x, P))
    didx2 = jax.device_put(didx2, sharding)
    return didx2, spec


def sharded_kmer_lookup(table: BucketTable, q: jnp.ndarray, axis: str,
                        slack: float = 2.0):
    """Inside shard_map: lookup canonical kmers [B_loc, S] against the
    row-sharded table (local view [R/n, W]).  Returns (hit, val) shaped
    [B_loc, S, E] exactly like BucketTable.lookup, plus an int32 overflow
    count (queries dropped by bucket capacity)."""
    n = jax.lax.axis_size(axis)
    E = table.entries
    Rn = int(table.rows.shape[0])      # local rows = R / n
    lg = _log2(Rn)
    Bq, S = q.shape
    M = Bq * S
    cap = -(-int(np.ceil(M / n * slack)) // 8) * 8

    h = ((q * jnp.uint32(MIX))
         >> jnp.uint32(32 - table.bits)).astype(jnp.int32).reshape(-1)
    owner = (h >> lg).astype(jnp.int32)                     # [M]
    local = h & jnp.int32(Rn - 1)
    # fixed-capacity bucketing by owner (stable sort + rank-in-group)
    order = jnp.argsort(owner, stable=True)
    own_s = owner[order]
    loc_s = local[order]
    ar = jnp.arange(M, dtype=jnp.int32)
    new_g = jnp.concatenate([jnp.ones(1, bool), own_s[1:] != own_s[:-1]])
    gstart = cummax(jnp.where(new_g, ar, 0))
    rank = ar - gstart
    ok = rank < cap
    overflow = jnp.sum((~ok).astype(jnp.int32))
    slot_s = jnp.where(ok, own_s * cap + rank, n * cap)     # n*cap = trash
    send = jnp.zeros((n * cap + 1,), jnp.int32).at[slot_s].set(
        jnp.where(ok, loc_s, 0))[:-1].reshape(n, cap)
    # queries -> owners; owner gathers its rows; rows ride straight back
    recv_q = jax.lax.all_to_all(send, axis, 0, 0, tiled=False)  # [n, cap]
    rows = table.rows[recv_q]                               # [n, cap, W]
    back = jax.lax.all_to_all(rows, axis, 0, 0, tiled=False)
    # slot of the original query i: scatter rank through the sort order
    slot = jnp.zeros((M,), jnp.int32).at[order].set(slot_s)
    got = slot < n * cap
    res = back.reshape(n * cap, -1)[jnp.minimum(slot, n * cap - 1)]
    keys = res[..., :E].reshape(Bq, S, E)
    vals = res[..., E:2 * E].reshape(Bq, S, E)
    hit = ((keys == q[..., None])
           & (q != jnp.uint32(0xFFFFFFFF))[..., None]
           & got.reshape(Bq, S)[..., None])
    return hit, vals, overflow
