"""Execution context: one object that hides single-chip vs multi-chip.

`run_count` builds an Executor once and calls it per batch; whether the
fused counting step runs on one device or SPMD over a jax.sharding.Mesh is
decided here, nowhere else.  This is the production wiring of the mesh
(VERDICT r1 item 1): batches shard over the `data` axis, the whitelist
bucket table is replicated, scalar metrics psum, and per-partition dedup
fans out one barcode-hash partition per device (parallel/mesh.py).

Multi-host: when `jax.process_count() > 1` (jax.distributed initialized,
see parallel/distributed.py), the mesh spans hosts; each host feeds its own
FASTQ subset and the psum/metric merges ride DCN.  Host-side spill files
live under the (shared) output directory, mirroring the reference's
shared-filesystem shardio exchange.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import make_sharded_step, make_sharded_part_dedup
from ..ops.dedup import dedup_molecules, exact_merge


def _pow2(n: int, minimum: int = 1024) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


# dedup output packing: one [N, 12] int32 plane = ONE device->host fetch
# per partition instead of 12 (each fetch is a synchronizing round trip).
# Runs without
# BAM/feature consumers fetch only the 5 molecule columns (raw-triple
# views unused): the 48MB-per-million-rows readback drops ~58%.
DD_FIELDS = ("mol_bc", "mol_gene", "mol_umi", "mol_reads", "mol_valid",
             "raw_bc", "raw_gene", "raw_umi", "raw_corr_umi", "raw_low",
             "raw_is_repr", "raw_reads")
DD_FIELDS_MOL = DD_FIELDS[:5]
DD_U32 = frozenset(("mol_bc", "mol_gene", "mol_umi", "raw_bc", "raw_gene",
                    "raw_umi", "raw_corr_umi"))


def _pack_dd(dd: dict, fields):
    cols = []
    for k in fields:
        a = dd[k]
        if a.dtype == jnp.uint32:
            a = jax.lax.bitcast_convert_type(a, jnp.int32)
        cols.append(a.astype(jnp.int32))
    return jnp.stack(cols, axis=1)


def _unpack_dd(plane: np.ndarray) -> dict:
    fields = DD_FIELDS if plane.shape[1] == len(DD_FIELDS) else DD_FIELDS_MOL
    out = {}
    for j, k in enumerate(fields):
        col = plane[:, j]
        out[k] = col.view(np.uint32) if k in DD_U32 else col
    return out


import functools


@functools.partial(jax.jit, static_argnames=("umi_len", "keep_raw"),
                   donate_argnums=(0, 1, 2, 3))
def _dedup_packed(bc, gene, umi, valid, umi_len: int,
                  keep_raw: bool = True, reads=None):
    dd = dedup_molecules(bc, gene, umi, valid, umi_len, reads=reads)
    dd.pop("n_molecules")
    return _pack_dd(dd, DD_FIELDS if keep_raw else DD_FIELDS_MOL)


# ---- device-resident molecule accumulator (count-only runs) ----
# The accumulate-mode step already keeps its conf-mapped rows on device;
# these two functions keep them there through dedup: absorb folds each
# drained [mol_cap, 3] append buffer into a persistent [C, 4] state with
# exact (bc, gene, umi) merging (safe pre-aggregation — UMI correction
# operates on distinct triples + counts), and the final dedup runs on the
# state in place.  The only host traffic of the whole dedup phase is the
# final valid-molecule fetch (the reference's mark_dups runs inside the
# alignment pass for the same reason: align_and_count.rs:292-333).

@functools.partial(jax.jit, donate_argnums=(0, 2))
def _absorb_append(state_rows, state_n, mol, mol_n):
    """Append a drained [B, 3] molecule buffer (live rows [0, mol_n)) to
    the [C, 4] state as weight-1 rows, WITHOUT merging.  Duplicate
    (bc, gene, umi) triples are fine: dedup_molecules sums read weights
    per distinct triple in its phase-0 sort, so merging is purely space
    reclamation — deferred to capacity pressure (MoleculeState.absorb).
    Merging at every drain would re-sort the whole multi-M-row state (a
    full 4-key device sort every 32 batches); appending is O(B). The
    caller guarantees the write window state_n + B <= C
    (dynamic_update_slice would clamp backwards over live rows otherwise).
    """
    B = mol.shape[0]
    live = jnp.arange(B, dtype=jnp.int32) < mol_n
    sent = jnp.uint32(0xFFFFFFFF)
    new_rows = jnp.concatenate(
        [jnp.where(live[:, None], mol, sent),
         jnp.where(live, 1, 0).astype(jnp.uint32)[:, None]], axis=1)
    rows = jax.lax.dynamic_update_slice(state_rows, new_rows,
                                        (state_n, jnp.int32(0)))
    return rows, state_n + mol_n


@functools.partial(jax.jit, static_argnames=("umi_len",),
                   donate_argnums=(0,))
def _dedup_state(rows, n, umi_len: int):
    """Final dedup of the merged state: UMI correction + low-support over
    the distinct triples (reads-weighted), valid molecules compacted to
    the front.  Returns ([C, 4] int32 plane (bc, gene, umi, reads),
    n_valid) — the host fetches plane[:next_pow2(n_valid)]."""
    C = rows.shape[0]
    live = jnp.arange(C, dtype=jnp.int32) < n
    dd = dedup_molecules(rows[:, 0], rows[:, 1], rows[:, 2], live,
                         umi_len, reads=rows[:, 3])
    inval = (~dd["mol_valid"]).astype(jnp.uint32)
    _, mb, mg, mu, mr = jax.lax.sort(
        (inval, dd["mol_bc"], dd["mol_gene"], dd["mol_umi"],
         dd["mol_reads"].astype(jnp.uint32)), num_keys=1)
    plane = jax.lax.bitcast_convert_type(
        jnp.stack([mb, mg, mu, mr], axis=1), jnp.int32)
    return plane, jnp.sum(dd["mol_valid"].astype(jnp.int32))


class MoleculeState:
    """Host handle on the device-resident merged molecule table.

    Capacity adapts geometrically (pow2 growth up to max_capacity, then
    host flush) so tiny runs sort tiny buffers — every distinct shape is
    one compile, and a run touches at most log2(max/min) of them."""

    def __init__(self, max_capacity: int, umi_len: int,
                 min_capacity: int = 1024):
        self.max_cap = max_capacity
        self.umi_len = umi_len
        self.cap = min_capacity
        self.rows = jnp.full((self.cap, 4), jnp.uint32(0xFFFFFFFF))
        self._n_dev = jnp.int32(0)
        self.n = 0          # host UPPER BOUND on live rows (see absorb)
        self.flushed: list = []  # host [k, 4] overflow arrays

    def _grow(self, need: int) -> None:
        cap = _pow2(need, minimum=self.cap)
        if cap == self.cap:
            return
        self.rows = jnp.concatenate(
            [self.rows,
             jnp.full((cap - self.cap, 4), jnp.uint32(0xFFFFFFFF))], axis=0)
        self.cap = cap

    def absorb(self, mol, mol_n, upper: int) -> None:
        """Append a drained device [B, 3] buffer into the state (donating
        the state); `upper` is the host-known bound on mol_n.

        NON-BLOCKING: the host tracks only the additive upper bound
        (n_prev + upper >= appended n), so the absorb dispatch returns
        without waiting for the device — a per-drain scalar fetch was a
        full pipeline sync inside pass 2.  Appends do NOT merge (a
        merge re-sorts the whole multi-M-row state);
        exact_merge runs only on capacity pressure to reclaim the space
        duplicate triples waste, followed by one exact-count fetch to
        tighten the bound."""
        P = _pow2(max(min(upper, int(mol.shape[0])), 1), minimum=1024)
        if self.n + P > self.max_cap:
            self.merge_now()             # compact + tighten the bound
            if self.n + P > self.max_cap:
                self.flush_to_host()
        self._grow(self.n + P)
        self.rows, self._n_dev = _absorb_append(
            self.rows, self._n_dev, mol[:P], mol_n)
        self.n = min(self.n + int(upper), self.cap)

    def merge_now(self) -> None:
        """Space reclamation: exact-merge duplicate triples in place and
        tighten the host bound to the exact merged count (one scalar
        fetch — the only sync of the dedup-overlap path)."""
        self.rows, self._n_dev = exact_merge(self.rows, self._n_dev)
        self.n = int(self._n_dev)

    def flush_to_host(self) -> None:
        """Overflow path (runs whose distinct triples exceed capacity):
        merge, fetch the rows, and reset.  The final dedup then runs
        over host partitions (reads-weighted)."""
        self.rows, self._n_dev = exact_merge(self.rows, self._n_dev)
        self.n = int(self._n_dev)   # exact count before the host slice
        self.flushed.append(np.asarray(self.rows)[:self.n])
        self.rows = jnp.full((self.cap, 4), jnp.uint32(0xFFFFFFFF))
        self._n_dev = jnp.int32(0)
        self.n = 0

    def finalize(self):
        """-> (bc, gene, umi, reads) uint32 host arrays of valid
        molecules, deduped fully on device when nothing overflowed."""
        if not self.flushed:
            # shrink to the tightest pow2 over the live rows (they are
            # contiguous in [0, _n_dev)), exact-merge the append-only
            # duplicates ONCE (one sort), and re-shrink: the full dedup
            # below is several sorts of its buffer, so when duplicates
            # halve the row count (every read a duplicate of some
            # molecule) the pre-merge pays for itself several times over
            self.n = int(self._n_dev)   # exact count (n was a bound)
            C2 = _pow2(max(self.n, 1), minimum=1024)
            rows = self.rows[:C2] if C2 < self.cap else self.rows
            rows, n_dev = exact_merge(rows, self._n_dev)
            self.n = int(n_dev)
            C3 = _pow2(max(self.n, 1), minimum=1024)
            if C3 < C2:
                rows = rows[:C3]
            plane, n_valid = _dedup_state(rows, n_dev, self.umi_len)
            self.rows = None
            nv = int(n_valid)
            out = np.asarray(plane[:_pow2(max(nv, 1))])[:nv]
            u = out.view(np.uint32)
            return u[:, 0], u[:, 1], u[:, 2], out[:, 3].astype(np.uint32)
        self.flush_to_host()
        allr = np.concatenate(self.flushed, axis=0)
        self.flushed = []
        return allr[:, 0], allr[:, 1], allr[:, 2], allr[:, 3]


class Executor:
    """Single- or multi-chip execution of the counting hot path."""

    def __init__(self, mesh: Mesh | None = None, axis: str = "data"):
        if mesh is not None and mesh.devices.size == 1:
            mesh = None  # degenerate mesh: run the plain single-chip path
        self.mesh = mesh
        self.axis = axis
        self.n_devices = mesh.devices.size if mesh is not None else 1
        self._sharding = (NamedSharding(mesh, P(axis))
                          if mesh is not None else None)
        self._dedup_fns: dict[int, object] = {}

    def round_batch(self, batch_size: int) -> int:
        """Round the batch size up so it splits evenly across devices."""
        n = self.n_devices
        return -(-batch_size // n) * n

    def put(self, a):
        """Device-put one batch array (dim 0 sharded when on a mesh)."""
        if self._sharding is None:
            return jnp.asarray(a)
        return jax.device_put(np.asarray(a), self._sharding)

    def wrap_step(self, step_fn, n_batch_args: int = 1):
        if self.mesh is None:
            return step_fn
        return make_sharded_step(step_fn, self.mesh, self.axis,
                                 n_batch_args=n_batch_args)

    def dedup_partitions(self, parts, umi_len: int,
                         chunk_limit: int = 1 << 21,
                         keep_raw: bool = True):
        """Dedup barcode-disjoint molecule partitions.

        parts: iterable of (bc, gene, umi) numpy row arrays; each partition
        holds complete barcodes.  Yields one host-side dict per device call
        with compacted molecule rows and raw-triple views:
          mol_bc/gene/umi/reads (valid molecules only),
          raw_bc/gene/umi/corr_umi/low (distinct raw triples only).
        On a mesh, n_devices partitions run per SPMD call (padded to a
        common power-of-two length; dedup output is pad-invariant since
        invalid rows carry sentinel keys).
        """
        parts = list(parts)
        if self.mesh is None:
            # COALESCE bc-disjoint partitions into as few device calls as
            # possible (each call is a dispatch plus a synchronizing
            # fetch), capped at
            # chunk_limit rows of working set; one COMMON padded shape
            # across groups so dedup compiles once
            groups: list[list] = []
            cur: list = []
            cur_n = 0
            for p in parts:
                n = len(p[0])
                if cur and cur_n + n > chunk_limit:
                    groups.append(cur)
                    cur, cur_n = [], 0
                cur.append(p)
                cur_n += n
            if cur:
                groups.append(cur)
            N = _pow2(max((sum(len(p[0]) for p in g) for g in groups),
                          default=1))
            for g in groups:
                bc = np.concatenate([p[0] for p in g])
                gene = np.concatenate([p[1] for p in g])
                umi = np.concatenate([p[2] for p in g])
                reads = (np.concatenate([p[3] for p in g])
                         if len(g[0]) >= 4 else None)
                yield self._dedup_host(bc, gene, umi, umi_len, N,
                                       keep_raw=keep_raw, reads=reads)
            return
        n = self.n_devices
        for i in range(0, len(parts), n):
            group = parts[i:i + n]
            real = len(group)
            while len(group) < n:
                group.append((np.zeros(0, np.uint32),) * 3)
            N = _pow2(max(max(len(g[0]) for g in group), 1))
            stack = {k: np.zeros((n, N), np.uint32)
                     for k in ("bc", "gene", "umi")}
            valid = np.zeros((n, N), bool)
            for d, (bc, gene, umi) in enumerate(group):
                stack["bc"][d, :len(bc)] = bc
                stack["gene"][d, :len(gene)] = gene
                stack["umi"][d, :len(umi)] = umi
                valid[d, :len(bc)] = True
            if N not in self._dedup_fns:
                self._dedup_fns[N] = make_sharded_part_dedup(
                    self.mesh, umi_len, self.axis)
            plane = self._dedup_fns[N](
                self.put(stack["bc"].reshape(-1)),
                self.put(stack["gene"].reshape(-1)),
                self.put(stack["umi"].reshape(-1)),
                self.put(valid.reshape(-1)))
            host = np.asarray(plane).reshape(n, N, len(DD_FIELDS))
            for d in range(real):
                yield self._compact(_unpack_dd(host[d]))

    def _dedup_host(self, bc, gene, umi, umi_len, N: int | None = None,
                    keep_raw: bool = True, reads=None):
        N = N or _pow2(max(len(bc), 1))
        pad = N - len(bc)
        plane = _dedup_packed(
            jnp.asarray(np.pad(np.asarray(bc, np.uint32), (0, pad))),
            jnp.asarray(np.pad(np.asarray(gene, np.uint32), (0, pad))),
            jnp.asarray(np.pad(np.asarray(umi, np.uint32), (0, pad))),
            jnp.asarray(np.pad(np.ones(len(bc), bool), (0, pad))),
            umi_len, keep_raw,
            None if reads is None else
            jnp.asarray(np.pad(np.asarray(reads, np.uint32), (0, pad))))
        return self._compact(_unpack_dd(np.asarray(plane)))

    @staticmethod
    def _compact(dd: dict) -> dict:
        mv = dd["mol_valid"].astype(bool)
        out = dict(
            mol_bc=dd["mol_bc"][mv], mol_gene=dd["mol_gene"][mv],
            mol_umi=dd["mol_umi"][mv], mol_reads=dd["mol_reads"][mv])
        if "raw_is_repr" in dd:
            rr = dd["raw_is_repr"].astype(bool)
            out.update(
                raw_bc=dd["raw_bc"][rr], raw_gene=dd["raw_gene"][rr],
                raw_umi=dd["raw_umi"][rr],
                raw_corr_umi=dd["raw_corr_umi"][rr],
                raw_low=dd["raw_low"][rr].astype(bool),
                raw_reads=dd["raw_reads"][rr])
        return out
