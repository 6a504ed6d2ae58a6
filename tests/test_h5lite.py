"""In-repo HDF5 writer/reader (io/h5lite.py): h5py reads what it writes,
and it reads back what it writes (and the goldens) without h5py."""

import json
import os
import sys

import h5py
import numpy as np
import pytest

from cellranger_tpu.io import h5lite

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("data", [
    np.arange(7, dtype=np.int32),
    np.arange(7, dtype=np.int64) - 3,
    np.arange(5, dtype=np.uint16),
    np.arange(12, dtype=np.uint64).reshape(4, 3),
    np.zeros((0, 3), np.uint64),
    np.linspace(-1, 1, 9, dtype=np.float32),
    np.linspace(-1, 1, 9),
    np.asarray([b"AAACCC-1", b"G", b""], dtype="S"),
    np.asarray([], dtype="S1"),
], ids=["i32", "i64", "u16", "u64_2d", "empty_2d", "f32", "f64", "bytes",
        "empty_bytes"])
def test_h5py_reads_written_dataset(tmp_path, data):
    path = str(tmp_path / "x.h5")
    with h5lite.File(path, "w") as f:
        f.create_group("g").create_dataset("d", data=data)
    with h5py.File(path, "r") as f:
        got = f["g/d"][()]
        assert got.dtype == data.dtype and got.shape == data.shape
        assert np.array_equal(got, data)
    assert np.array_equal(h5lite.File(path)["g/d"][()], data)


def test_attrs_and_vlen_strings_match_h5py(tmp_path):
    """Same tree written by h5py and by h5lite compares clean, attribute
    and string types included (str -> variable-length UTF-8)."""
    from cellranger_tpu.testing.correctness import check_h5

    def build(f):
        f.attrs["filetype"] = "matrix"
        f.attrs["version"] = 2
        f.attrs["library_ids"] = np.asarray([b"count"], dtype="S")
        f.attrs["original_gem_groups"] = np.asarray([1], np.int64)
        f.create_dataset("metrics_json", data=json.dumps({"a": 1.5}))
        f.create_group("a").create_group("b").create_dataset(
            "c", data=np.arange(3))
    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    with h5py.File(a, "w") as f:
        build(f)
    with h5lite.File(b, "w") as f:
        build(f)
    assert check_h5(b, a, ignore_attrs=()) == []
    r = h5lite.File(b)
    assert r.attrs["filetype"] == "matrix" and r.attrs["version"] == 2
    assert json.loads(r["metrics_json"][()]) == {"a": 1.5}
    assert r.keys() == ["a", "metrics_json"]
    assert np.array_equal(r["a/b/c"][()], np.arange(3))


def test_lookup3_reference_vectors():
    # hashlittle test vectors from Bob Jenkins' lookup3.c self-test
    assert h5lite.lookup3(b"") == 0xDEADBEEF
    assert h5lite.lookup3(b"", 0xDEADBEEF) == 0xBD5B7DDE
    assert h5lite.lookup3(b"Four score and seven years ago") == 0x17770551
    assert h5lite.lookup3(b"Four score and seven years ago", 1) == 0xCD628161


@pytest.mark.parametrize("rel", ["e2e/filtered_feature_bc_matrix.h5",
                                 "e2e/molecule_info.h5",
                                 "e2e_rich/filtered_feature_bc_matrix.h5",
                                 "e2e_rich/molecule_info.h5"])
def test_reader_matches_h5py_on_goldens(rel):
    path = os.path.join(GOLDEN, rel)
    r = h5lite.File(path)

    def walk(a, b):
        assert a.keys() == sorted(b.keys())
        assert set(a.attrs) == set(b.attrs)
        for k, v in b.attrs.items():
            assert np.array_equal(np.asarray(a.attrs[k]), np.asarray(v))
        for k in b.keys():
            if isinstance(b[k], h5py.Group):
                walk(a[k], b[k])
            else:
                assert np.array_equal(np.asarray(a[k][()]),
                                      np.asarray(b[k][()]))

    with h5py.File(path, "r") as f:
        walk(r, f)


def test_loaders_and_comparators_without_h5py(tmp_path, monkeypatch):
    """Where h5py is not installed, the matrix/molecule_info loaders and
    the golden comparators read through h5lite."""
    from cellranger_tpu.io.matrix_io import CountMatrix
    from cellranger_tpu.io.molecule_info import load_molecule_info
    from cellranger_tpu.testing import correctness as cc

    with h5py.File(os.path.join(GOLDEN, "e2e/molecule_info.h5")) as f:
        want_umi = f["umi"][:]
    monkeypatch.setitem(sys.modules, "h5py", None)
    mi = load_molecule_info(os.path.join(GOLDEN, "e2e/molecule_info.h5"))
    assert np.array_equal(mi["umi"], want_umi) and mi["file_version"] == 6
    m = CountMatrix.load_h5(os.path.join(GOLDEN,
                                         "e2e/filtered_feature_bc_matrix.h5"))
    out = str(tmp_path / "m.h5")
    m.save_h5(out)
    again = CountMatrix.load_h5(out)
    assert (again.m != m.m).nnz == 0 and again.barcodes == m.barcodes
    g = os.path.join(GOLDEN, "e2e_rich", "filtered_feature_bc_matrix.h5")
    assert cc.check_h5(g, g) == []
    assert cc.check_h5(out, g) != []
