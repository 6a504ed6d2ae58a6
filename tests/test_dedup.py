"""Device dedup kernel vs the plain-python reference-spec oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from cellranger_tpu.ops.dedup import dedup_molecules
from ref_dedup import dedup_spec

UMI_LEN = 6  # short UMIs make 1-Hamming collisions common in tests


def run_both(rows, n_pad):
    rows = list(rows)
    N = n_pad
    bc = np.zeros(N, np.uint32)
    gene = np.zeros(N, np.uint32)
    umi = np.zeros(N, np.uint32)
    valid = np.zeros(N, bool)
    for i, (b, g, u) in enumerate(rows):
        bc[i], gene[i], umi[i], valid[i] = b, g, u, True
    out = dedup_molecules(jnp.asarray(bc), jnp.asarray(gene), jnp.asarray(umi),
                          jnp.asarray(valid), UMI_LEN)
    out = {k: np.asarray(v) for k, v in out.items()}
    spec_mols, spec_low = dedup_spec(rows, UMI_LEN)
    spec_valid = {k: v for k, v in spec_mols.items() if k not in spec_low}

    got = {}
    for i in range(N):
        if out["mol_valid"][i]:
            key = (int(out["mol_bc"][i]), int(out["mol_gene"][i]), int(out["mol_umi"][i]))
            got[key] = int(out["mol_reads"][i])
    return got, spec_valid, out


def test_simple_dedup():
    # 3 reads same molecule, 2 reads another
    rows = [(1, 0, 9)] * 3 + [(1, 0, 33)] * 2
    got, spec, _ = run_both(rows, 16)
    assert got == spec == {(1, 0, 9): 3, (1, 0, 33): 2}


def test_umi_correction_merges():
    # umi 0b000001 (1 read) is 1-HD from 0b000011 (5 reads): merges
    rows = [(7, 2, 0b000011)] * 5 + [(7, 2, 0b000001)]
    got, spec, _ = run_both(rows, 16)
    assert got == spec == {(7, 2, 0b000011): 6}


def test_tie_goes_to_lex_larger():
    # equal counts: both collapse onto the numerically larger UMI
    rows = [(3, 1, 0b100000)] * 2 + [(3, 1, 0b110000)] * 2
    got, spec, _ = run_both(rows, 16)
    assert got == spec
    assert got == {(3, 1, 0b110000): 4}


def test_chimera_low_support_filter():
    # same (bc, umi) seen for two genes: minor gene is low-support
    rows = [(5, 0, 42)] * 10 + [(5, 1, 42)] * 1
    got, spec, _ = run_both(rows, 16)
    assert got == spec == {(5, 0, 42): 10}


def test_chimera_tie_discards_all():
    rows = [(5, 0, 42)] * 3 + [(5, 1, 42)] * 3
    got, spec, _ = run_both(rows, 16)
    assert got == spec == {}


def test_randomized_vs_spec():
    rng = np.random.default_rng(123)
    for trial in range(5):
        n = int(rng.integers(50, 400))
        rows = [(int(rng.integers(4)), int(rng.integers(3)),
                 int(rng.integers(0, 1 << (2 * UMI_LEN)) & ((1 << (2*UMI_LEN)) - 1)))
                for _ in range(n)]
        # bias umis into a small space to force 1-HD neighborhoods
        rows = [(b, g, u & 0b11001100) for (b, g, u) in rows]
        got, spec, _ = run_both(rows, 512)
        assert got == spec, f"trial {trial}: device != spec\n{got}\n{spec}"


def test_all_invalid():
    got, spec, out = run_both([], 16)
    assert got == {} and int(out["n_molecules"]) == 0


def test_executor_coalesced_dedup_matches_per_partition():
    """Coalescing bc-disjoint partitions into one device call (fewer
    dispatches and fetches) must produce the same molecule table as
    separate per-partition calls."""
    import numpy as np
    from cellranger_tpu.parallel.executor import Executor

    rng = np.random.default_rng(13)
    parts = []
    for p in range(6):
        n = int(rng.integers(50, 400))
        bc = (rng.integers(0, 100, n) * 6 + p).astype(np.uint32)  # disjoint
        gene = rng.integers(0, 20, n).astype(np.uint32)
        umi = rng.integers(0, 1 << 12, n).astype(np.uint32)
        parts.append((bc, gene, umi))

    ex = Executor(None)

    def collect(chunk_limit):
        rows = []
        for dd in ex.dedup_partitions(parts, 12, chunk_limit=chunk_limit):
            rows.append(np.stack([dd["mol_bc"], dd["mol_gene"],
                                  dd["mol_umi"], dd["mol_reads"]], 1))
        out = np.concatenate(rows)
        return out[np.lexsort((out[:, 2], out[:, 1], out[:, 0]))]

    one_call = collect(chunk_limit=1 << 20)    # everything coalesced
    per_part = collect(chunk_limit=1)          # one call per partition
    np.testing.assert_array_equal(one_call, per_part)
