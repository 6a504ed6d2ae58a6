"""Native (C++) FASTQ reader: bit-identical to the python path."""

import gzip

import numpy as np
import pytest

from cellranger_tpu.io.chemistry import get_chemistry
from cellranger_tpu.io.fastq import batches_from_fastqs
from cellranger_tpu import native
from cellranger_tpu.native import NativeFastqReader, get_lib


pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="no native toolchain")


def _write(path, recs):
    with gzip.open(path, "wt") as f:
        for name, seq, qual in recs:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")


def test_reader_basic(tmp_path):
    p = str(tmp_path / "a.fastq.gz")
    _write(p, [("r1 extra stuff", "ACGT", "FFFF"), ("r2", "GGGTTT", "IIIIII")])
    rd = NativeFastqReader(p, keep_names=True)
    seqs, quals, lens, names = rd.read_batch(10, 8)
    assert len(seqs) == 2
    assert bytes(seqs[0][:4]) == b"ACGT" and lens[0] == 4
    assert bytes(seqs[1][:6]) == b"GGGTTT" and lens[1] == 6
    assert bytes(quals[1][:6]) == b"IIIIII"
    assert names == [b"r1", b"r2"]
    s2, _, _, _ = rd.read_batch(10, 8)
    assert len(s2) == 0


def test_reader_malformed(tmp_path):
    p = str(tmp_path / "bad.fastq.gz")
    with gzip.open(p, "wt") as f:
        f.write("not a fastq\nrecord\n")
    rd = NativeFastqReader(p)
    with pytest.raises(ValueError, match="malformed"):
        rd.read_batch(4, 8)


def test_native_matches_python_batches(tmp_path):
    rng = np.random.default_rng(0)
    chem = get_chemistry("SC3Pv3")
    r1p, r2p = str(tmp_path / "x_R1_.fastq.gz"), str(tmp_path / "x_R2_.fastq.gz")
    recs1, recs2 = [], []
    for i in range(300):
        bc = "".join(rng.choice(list("ACGT"), 28))
        cdna = "".join(rng.choice(list("ACGTN"), int(rng.integers(50, 92))))
        recs1.append((f"n{i}", bc, "F" * 28))
        recs2.append((f"n{i}", cdna, "I" * len(cdna)))
    _write(r1p, recs1)
    _write(r2p, recs2)
    py = list(batches_from_fastqs(chem, r1p, r2p, 128, 91, keep_names=True,
                                  use_native=False))
    na = list(batches_from_fastqs(chem, r1p, r2p, 128, 91, keep_names=True,
                                  use_native=True))
    assert len(py) == len(na)
    for b1, b2 in zip(py, na):
        assert b1.n_reads == b2.n_reads
        assert b1.names == b2.names
        for f in ["bc_packed", "bc_qual", "bc_exact", "umi_packed",
                  "umi_valid", "umi_qual", "rna", "rna_nmask", "rna_len",
                  "rna_qual", "slot_valid", "read_id"]:
            np.testing.assert_array_equal(getattr(b1, f), getattr(b2, f),
                                          err_msg=f)


def test_library_is_keyed_on_the_source_hash():
    """A library built from other source (or left in a copied tree) is
    never loaded: the file name carries a hash of fastq_reader.cpp."""
    import hashlib
    import os
    src = os.path.join(os.path.dirname(native.__file__), "fastq_reader.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    assert native.lib_path().endswith(f"libfastq_reader.{digest}.so")
    assert get_lib() is not None and os.path.exists(native.lib_path())
