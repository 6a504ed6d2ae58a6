"""Open-addressing hash table for device kmer lookup.

Replaces the bucketed binary search for the aligner's seed lookup: one
gather of a PROBE-slot contiguous window per query (keys + positions)
instead of a 6-step sequential search loop (contiguous 8-slot windows
lower to sliced gathers; dependent-iteration searches are bound by memory
latency). Superseded by ops.bucket_table for the hot lookups.

Layout: slots = next_pow2(n / load); hash = (key * 0x9E3779B9) >> (32-bits);
entries with equal keys (multi-occurrence kmers) and colliding buckets sit
consecutively after their home slot (robin-hood-free linear probing,
host-built with a vectorized multi-pass displacement scheme). Queries probe
a fixed PROBE-slot window: entries beyond it are dropped (repetitive kmers
degrade gracefully, like the H-hit cap). The all-ones key is reserved as
EMPTY (the poly-T 16-mer — adapter junk — is dropped at build).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_dataclass

EMPTY = np.uint32(0xFFFFFFFF)
MIX = np.uint32(0x9E3779B9)
PROBE = 8


@register_dataclass
@dataclass(frozen=True)
class HashTable:
    # interleaved (key, val) pairs: one contiguous 32B probe window fetches
    # both sides in a single gather (random HBM access is latency-bound)
    kv: jnp.ndarray      # uint32 [slots, 2]
    bits: int = field(metadata=dict(static=True), default=20)
    probe: int = field(metadata=dict(static=True), default=PROBE)

    @property
    def slots(self) -> int:
        return 1 << self.bits

    @property
    def keys(self):
        return self.kv[:, 0]

    @staticmethod
    def build(keys: np.ndarray, vals: np.ndarray, load: float = 0.5,
              max_passes: int = 200, probe: int = PROBE) -> "HashTable":
        keys = np.asarray(keys, np.uint32)
        vals = np.asarray(vals, np.uint32)
        keep = keys != EMPTY
        keys, vals = keys[keep], vals[keep]
        n = len(keys)
        bits = max(10, int(np.ceil(np.log2(max(n, 1) / load))))
        slots = 1 << bits

        h = ((keys * MIX) >> np.uint32(32 - bits)).astype(np.int64)
        order = np.argsort(h, kind="stable")
        hs, ks, vs = h[order], keys[order], vals[order]
        new_b = np.concatenate([[True], hs[1:] != hs[:-1]])
        start = np.maximum.accumulate(np.where(new_b, np.arange(n), 0))
        slot = (hs + (np.arange(n) - start)) % slots
        # resolve inter-bucket collisions: bump colliding entries one slot
        # per pass (vectorized linear probing)
        for _ in range(max_passes):
            o2 = np.argsort(slot, kind="stable")
            ss = slot[o2]
            dup = np.concatenate([[False], ss[1:] == ss[:-1]])
            if not dup.any():
                break
            bump = np.zeros(n, np.int64)
            bump[o2] = dup
            slot = (slot + bump) % slots
        # first-come-first-placed per slot; unresolved leftovers (only for
        # pathological clustering at this load factor) are dropped — probing
        # misses them, which degrades like the per-seed hit cap
        table = np.zeros((slots, 2), np.uint32)
        table[:, 0] = EMPTY
        o3 = np.argsort(slot, kind="stable")
        srt = slot[o3]
        lead = np.concatenate([[True], srt[1:] != srt[:-1]]) if n else srt > 0
        place = o3[lead] if n else o3
        table[slot[place], 0] = ks[place]
        table[slot[place], 1] = vs[place]
        return HashTable(kv=jnp.asarray(table), bits=bits, probe=probe)

    @staticmethod
    def build_exact(keys: np.ndarray, vals: np.ndarray,
                    load: float = 0.25, probe: int = 2) -> "HashTable":
        """Build guaranteeing every key is findable within the probe window
        (required for whitelist membership): verifies on host and widens the
        probe / halves the load until exact."""
        keys = np.asarray(keys, np.uint32)
        for attempt_load, attempt_probe in (
                (load, probe), (load, probe * 2), (load / 2, probe * 2),
                (load / 4, probe * 4), (load / 4, 8)):
            t = HashTable.build(keys, vals, load=attempt_load,
                                probe=attempt_probe)
            table = np.asarray(t.kv[:, 0])
            bits = t.bits
            h = ((keys[keys != EMPTY] * MIX)
                 >> np.uint32(32 - bits)).astype(np.int64)
            found = np.zeros(len(h), bool)
            for j in range(attempt_probe):
                sl = np.minimum(h + j, (1 << bits) - 1)
                found |= table[sl] == keys[keys != EMPTY]
            if found.all():
                return t
        raise ValueError("hash table could not be made exact; "
                         "pathological key distribution")

    def lookup(self, q: jnp.ndarray, probe: int | None = None):
        """q uint32 [...] -> (hit bool [..., probe], vals uint32 [..., probe]).

        hit[..., j] marks probe-window entries whose key equals the query;
        vals are the stored positions (valid where hit)."""
        probe = probe or self.probe
        hh = ((q * jnp.uint32(0x9E3779B9))
              >> jnp.uint32(32 - self.bits)).astype(jnp.int32)
        sl = jnp.minimum(hh[..., None] + jnp.arange(probe, dtype=jnp.int32),
                         self.slots - 1)
        kv = self.kv[sl]                       # [..., probe, 2] one gather
        kk = kv[..., 0]
        vv = kv[..., 1]
        # the all-ones key is the empty-slot sentinel: it can never hit
        hit = (kk == q[..., None]) & (q != jnp.uint32(0xFFFFFFFF))[..., None]
        return hit, vv

    def membership(self, q: jnp.ndarray, probe: int | None = None):
        """Unique-key tables (whitelists): (is_member bool, val int32, -1 on
        miss) — same contract as SortedTable.membership."""
        hits, vv = self.lookup(q, probe=probe or self.probe)
        hit = hits.any(axis=-1)
        val = jnp.max(jnp.where(hits, vv.astype(jnp.int32), -1), axis=-1)
        return hit, val
