"""Minimizer-sampled index + parity position packing (human-genome scale).

The reference handles 3Gb genomes via STAR's suffix array on 64-bit
hosts; our device index instead shrinks to device-memory scale by
winnowing (density ~2/(w+1)) and packs full u32 coordinates by
riding the strand bit in the position's parity bit. These tests force both modes on
small genomes and require exact position recovery.
"""

import numpy as np
import pytest

from cellranger_tpu.align.index import (
    GenomeIndex, MINIMIZER_HASH, MINIMIZER_W, minimizer_mask)
from cellranger_tpu.align.aligner import DeviceIndex, make_aligner

from util import random_genome, mutate, revcomp
from test_aligner import codes_batch

READ_LEN = 91


def test_minimizer_mask_matches_bruteforce():
    rng = np.random.default_rng(0)
    mh = rng.integers(0, 2**32, size=500, dtype=np.uint32)
    w = 12
    got = minimizer_mask(mh, w)
    n = len(mh)
    expect = np.zeros(n, bool)
    for j in range(n - w + 1):
        expect[j + int(np.argmin(mh[j:j + w]))] = True
    # brute force picks the FIRST min of each window; the mask marks every
    # position equal to its covering window min — a superset on ties only
    assert (got & ~expect).sum() <= (mh[got].size - np.unique(mh[got]).size)
    assert (expect & ~got).sum() == 0
    # every window has at least one pick
    for j in range(n - w + 1):
        assert got[j:j + w].any()


def test_minimizer_density():
    rng = np.random.default_rng(1)
    mh = rng.integers(0, 2**32, size=100_000, dtype=np.uint32)
    d = minimizer_mask(mh, MINIMIZER_W).mean()
    assert abs(d - 2 / (MINIMIZER_W + 1)) < 0.02


def _map_reads(didx, genome, n=256, seed=7, mutations=3):
    rng = np.random.default_rng(seed)
    align = make_aligner(didx, READ_LEN)
    truth_pos, reads, strands = [], [], []
    for _ in range(n):
        p = int(rng.integers(0, len(genome) - READ_LEN))
        frag = mutate(rng, genome[p:p + READ_LEN], mutations)
        st = int(rng.integers(2))
        reads.append(revcomp(frag) if st else frag)
        truth_pos.append(p)
        strands.append(st)
    codes, mask = codes_batch(reads, READ_LEN)
    out = align(codes, mask)
    pos = np.asarray(out["pos"]).astype(np.int64)
    ok = (np.asarray(out["mapped"])
          & (pos == np.asarray(truth_pos))
          & (np.asarray(out["strand"]) == np.asarray(strands)))
    return ok.mean(), out


@pytest.mark.parametrize("pos_mode", ["strand31", "parity"])
def test_minimizer_alignment(pos_mode):
    rng = np.random.default_rng(3)
    genome = random_genome(rng, 120_000)
    gi = GenomeIndex.build({"chr1": genome}, None, sampling="minimizer",
                           pos_mode=pos_mode)
    assert gi.sampling == "minimizer" and gi.pos_mode == pos_mode
    # winnowed table is ~2/(w+1) the dense size
    assert len(gi.kmer_keys) < 0.25 * len(genome)
    frac, _ = _map_reads(DeviceIndex.from_host(gi), genome)
    assert frac > 0.95, f"only {frac:.2%} mapped to exact positions"


def test_every_parity_alignment():
    # parity packing with dense sampling (explicit override)
    rng = np.random.default_rng(4)
    genome = random_genome(rng, 60_000)
    gi = GenomeIndex.build({"chr1": genome}, None, sampling="every",
                           pos_mode="parity")
    frac, _ = _map_reads(DeviceIndex.from_host(gi), genome)
    assert frac > 0.97


def test_minimizer_matches_dense_positions():
    # same reads through dense and winnowed indexes agree on unique loci
    rng = np.random.default_rng(5)
    genome = random_genome(rng, 80_000)
    gi_d = GenomeIndex.build({"chr1": genome}, None, sampling="every")
    gi_m = GenomeIndex.build({"chr1": genome}, None, sampling="minimizer",
                             pos_mode="parity")
    rng2 = np.random.default_rng(6)
    reads = []
    for _ in range(128):
        p = int(rng2.integers(0, len(genome) - READ_LEN))
        reads.append(genome[p:p + READ_LEN])
    codes, mask = codes_batch(reads, READ_LEN)
    out_d = make_aligner(DeviceIndex.from_host(gi_d), READ_LEN)(codes, mask)
    out_m = make_aligner(DeviceIndex.from_host(gi_m), READ_LEN)(codes, mask)
    both = np.asarray(out_d["mapped"]) & np.asarray(out_m["mapped"])
    assert both.mean() > 0.95
    pd = np.asarray(out_d["pos"]).astype(np.int64)[both]
    pm = np.asarray(out_m["pos"]).astype(np.int64)[both]
    assert (pd == pm).mean() > 0.99
