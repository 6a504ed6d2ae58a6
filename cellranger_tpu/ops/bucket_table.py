"""Bucket-row hash table: ONE aligned row gather per query.

A random gather from device memory costs per ROW (memory transactions)
far more than per byte: a small row and a 64-byte row cost about the
same. So the unit of cost is the row fetch — a lookup structure should
put the whole answer for a query in one aligned row. This replaces ops.hash_index's
slot-probing table (which cost `probe` row fetches per query) for the hot
lookups:

  * genome kmer index (duplicate keys: up to E positions surface per kmer,
    the MAX_HITS cap of the seed stage);
  * whitelist membership + correction (unique keys; the per-barcode prior
    count is stored IN the row, so the 48-candidate correction probe needs
    exactly one gather per candidate).

Layout: R = 2^bits rows, each row = E entries stored columnar
[key*E | val*E | (cnt*E) | pad], padded to a power-of-two u32 width so rows
stay aligned. bucket(key) = (key * 0x9E3779B9) >> (32-bits). Entries
land in their bucket row in input order; when a bucket overflows, entries
spill to the NEXT row if `probe_rows`=2 (queries then fetch both rows), or
are dropped (counted) — duplicates degrade exactly like the reference's
multimapper hit cap. `build_exact` grows the table until nothing drops
(required for whitelists). The all-ones key is reserved as EMPTY.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_dataclass

EMPTY = np.uint32(0xFFFFFFFF)
MIX = np.uint32(0x9E3779B9)


def _pad_width(e: int, f: int) -> int:
    w = 1
    while w < e * f:
        w *= 2
    return w


@register_dataclass
@dataclass(frozen=True)
class BucketTable:
    rows: jnp.ndarray  # uint32 [R(+1), W] columnar keys|vals|(cnts)|pad
    bits: int = field(metadata=dict(static=True), default=16)
    entries: int = field(metadata=dict(static=True), default=8)
    fields: int = field(metadata=dict(static=True), default=2)
    probe_rows: int = field(metadata=dict(static=True), default=1)

    @property
    def n_rows(self) -> int:
        return 1 << self.bits

    # ---------- build ----------
    @staticmethod
    def _place(keys: np.ndarray, vals: np.ndarray, bits: int, entries: int,
               fields: int, probe_rows: int, cnts: np.ndarray | None = None):
        """Vectorized placement; returns (rows, n_dropped)."""
        R = 1 << bits
        E = entries
        W = _pad_width(E, fields)
        h = ((keys * MIX) >> np.uint32(32 - bits)).astype(np.int64)
        order = np.argsort(h, kind="stable")
        hs, ks, vs = h[order], keys[order], vals[order]
        cs = cnts[order] if cnts is not None else None
        n = len(ks)
        newb = np.concatenate([[True], hs[1:] != hs[:-1]]) if n else np.zeros(0, bool)
        start = np.maximum.accumulate(np.where(newb, np.arange(n), 0)) if n else hs
        rank = np.arange(n) - start

        row = hs.copy()
        slot = rank.copy()
        if probe_rows == 2:
            # overflow entries spill to the next row, stacked after that
            # row's native entries (single-step spill; deeper overflow drops)
            over = rank >= E
            if over.any():
                nxt = hs + 1  # no wrap: row R is the dedicated spill pad row
                native = np.bincount(hs[~over], minlength=R + 1)[: R + 1]
                native = np.minimum(native, E)
                # per-next-row running index among spilled entries
                o_idx = np.flatnonzero(over)
                o_next = nxt[o_idx]
                o_order = np.argsort(o_next, kind="stable")
                o_sorted = o_next[o_order]
                nb = np.concatenate([[True], o_sorted[1:] != o_sorted[:-1]])
                st = np.maximum.accumulate(np.where(nb, np.arange(len(o_sorted)), 0))
                spill_rank = np.arange(len(o_sorted)) - st
                row_o = o_sorted
                slot_o = native[o_sorted] + spill_rank
                row[o_idx[o_order]] = row_o
                slot[o_idx[o_order]] = slot_o
        keep = slot < E
        n_dropped = int((~keep).sum())
        rows = np.zeros((R + 1, W), np.uint32)
        rows[:, :E] = EMPTY
        r_k, s_k = row[keep], slot[keep]
        rows[r_k, s_k] = ks[keep]
        rows[r_k, E + s_k] = vs[keep]
        if fields >= 3:
            if cs is not None:
                rows[r_k, 2 * E + s_k] = cs[keep]
        return rows, n_dropped

    @staticmethod
    def build_rows(keys: np.ndarray, vals: np.ndarray, entries: int = 8,
                   fields: int = 2, load: float = 0.5, probe_rows: int = 1,
                   min_bits: int = 8):
        """Host placement only: -> (rows numpy, bits).  Lets callers
        sidecar-cache the placed rows (the placement argsorts every
        entry — minutes of host time at GRCh38 scale)."""
        keys = np.asarray(keys, np.uint32)
        vals = np.asarray(vals, np.uint32)
        keep = keys != EMPTY
        keys, vals = keys[keep], vals[keep]
        n = max(len(keys), 1)
        bits = max(min_bits, int(np.ceil(np.log2(n / (entries * load)))))
        rows, _ = BucketTable._place(keys, vals, bits, entries, fields,
                                     probe_rows)
        return rows, bits

    @staticmethod
    def build(keys: np.ndarray, vals: np.ndarray, entries: int = 8,
              fields: int = 2, load: float = 0.5, probe_rows: int = 1,
              min_bits: int = 8) -> "BucketTable":
        """Best-effort build: bucket overflow beyond capacity is dropped
        (degrades like the seed hit cap)."""
        rows, bits = BucketTable.build_rows(keys, vals, entries, fields,
                                            load, probe_rows, min_bits)
        return BucketTable(rows=jnp.asarray(rows), bits=bits, entries=entries,
                           fields=fields, probe_rows=probe_rows)

    @staticmethod
    def build_exact(keys: np.ndarray, vals: np.ndarray, entries: int = 8,
                    fields: int = 3, load: float = 0.5,
                    max_bytes: int = 2 << 30) -> "BucketTable":
        """Grow (then widen to probe_rows=2) until every key is placed —
        required for whitelist membership."""
        keys = np.asarray(keys, np.uint32)
        vals = np.asarray(vals, np.uint32)
        keep = keys != EMPTY
        keys, vals = keys[keep], vals[keep]
        n = max(len(keys), 1)
        W = _pad_width(entries, fields)
        bits = max(8, int(np.ceil(np.log2(n / (entries * load)))))
        for probe_rows in (1, 2):
            b = bits
            while ((1 << b) + 1) * W * 4 <= max_bytes:
                rows, dropped = BucketTable._place(
                    keys, vals, b, entries, fields, probe_rows)
                if dropped == 0:
                    return BucketTable(rows=jnp.asarray(rows), bits=b,
                                       entries=entries, fields=fields,
                                       probe_rows=probe_rows)
                b += 1
        raise ValueError("bucket table could not be made exact within "
                         f"max_bytes={max_bytes}")

    def with_counts(self, counts: np.ndarray) -> "BucketTable":
        """Fill the count column from `counts` indexed by the val column
        (whitelist prior counts for posterior correction). Host op, once
        per run."""
        assert self.fields >= 3
        E = self.entries
        rows = np.asarray(self.rows).copy()
        valid = rows[:, :E] != EMPTY
        idx = np.where(valid, rows[:, E:2 * E], 0).astype(np.int64)
        counts = np.asarray(counts)
        idx = np.minimum(idx, max(len(counts) - 1, 0))
        rows[:, 2 * E:3 * E] = np.where(valid, counts[idx], 0).astype(np.uint32)
        return BucketTable(rows=jnp.asarray(rows), bits=self.bits,
                           entries=self.entries, fields=self.fields,
                           probe_rows=self.probe_rows)

    # ---------- query ----------
    def _fetch(self, q: jnp.ndarray):
        """q uint32 [...] -> (keys, vals, cnts) each [..., P*E]."""
        E = self.entries
        h = ((q * jnp.uint32(0x9E3779B9))
             >> jnp.uint32(32 - self.bits)).astype(jnp.int32)
        rows = self.rows[h]                       # [..., W] one gather
        keys, vals = rows[..., :E], rows[..., E:2 * E]
        cnts = rows[..., 2 * E:3 * E] if self.fields >= 3 else None
        if self.probe_rows == 2:
            rows2 = self.rows[h + 1]              # second gather (spill row)
            keys = jnp.concatenate([keys, rows2[..., :E]], axis=-1)
            vals = jnp.concatenate([vals, rows2[..., E:2 * E]], axis=-1)
            if cnts is not None:
                cnts = jnp.concatenate([cnts, rows2[..., 2 * E:3 * E]], axis=-1)
        return keys, vals, cnts

    def lookup(self, q: jnp.ndarray):
        """-> (hit bool [..., P*E], vals uint32 [..., P*E]); rows beyond a
        spill boundary never match their source bucket's key spuriously
        because keys are compared exactly."""
        keys, vals, _ = self._fetch(q)
        hit = (keys == q[..., None]) & (q != jnp.uint32(0xFFFFFFFF))[..., None]
        return hit, vals

    def membership(self, q: jnp.ndarray):
        """Unique-key tables: (is_member bool, val int32 — -1 on miss)."""
        hit, vals = self.lookup(q)
        any_hit = hit.any(axis=-1)
        val = jnp.max(jnp.where(hit, vals.astype(jnp.int32), -1), axis=-1)
        return any_hit, val

    def membership3(self, q: jnp.ndarray):
        """(is_member, val int32, count int32) — count column from the row."""
        keys, vals, cnts = self._fetch(q)
        hit = (keys == q[..., None]) & (q != jnp.uint32(0xFFFFFFFF))[..., None]
        any_hit = hit.any(axis=-1)
        val = jnp.max(jnp.where(hit, vals.astype(jnp.int32), -1), axis=-1)
        cnt = jnp.max(jnp.where(hit, cnts.astype(jnp.int32), 0), axis=-1)
        return any_hit, val, cnt
