"""Site-tunable parameters (parameters.toml analog)."""

import os

import pytest

from cellranger_tpu import params


def test_defaults():
    assert params.get("max_multiplexing_tags") == 12
    assert params.get("min_fraction_whitelist_match") == 0.1
    with pytest.raises(KeyError):
        params.get("nonexistent_knob")


def test_site_file_override(tmp_path, monkeypatch):
    p = tmp_path / "parameters.toml"
    p.write_text('min_fraction_whitelist_match = 0.25  # stricter site\n'
                 'align_extra_parameters = "foo bar"\n'
                 'fiveprime_multiplexing = false\n'
                 'vdj_max_reads_per_barcode = 50_000\n')
    monkeypatch.setenv(params.ENV_VAR, str(p))
    table = params.load(refresh=True)
    assert table["min_fraction_whitelist_match"] == 0.25
    assert table["align_extra_parameters"] == "foo bar"
    assert table["fiveprime_multiplexing"] is False
    assert table["vdj_max_reads_per_barcode"] == 50_000
    # untouched keys keep defaults
    assert table["max_multiplexing_tags"] == 12
    monkeypatch.delenv(params.ENV_VAR)
    params.load(refresh=True)


def test_detect_chemistry_uses_min_frac(tmp_path, monkeypatch):
    import gzip
    import numpy as np
    from cellranger_tpu.io.whitelist import Whitelist
    from cellranger_tpu.pipeline.detect_chemistry import detect_chemistry
    rng = np.random.default_rng(3)
    wl = sorted({"".join(rng.choice(list("ACGT"), 16)) for _ in range(200)})
    wls = {"3M-february-2018": Whitelist.from_seqs(wl)}
    r1 = str(tmp_path / "r1.fastq.gz")
    with gzip.open(r1, "wt") as f:
        for i in range(200):
            # 50% whitelist hits
            bc = wl[i % len(wl)] if i % 2 == 0 else \
                "".join(rng.choice(list("ACGT"), 16))
            umi = "".join(rng.choice(list("ACGT"), 12))
            f.write(f"@r{i}\n{bc}{umi}\n+\n{'F' * 28}\n")
    ok = detect_chemistry(r1, wls, candidates=("SC3Pv3",), n_sample=200)
    assert ok["chemistry"] == "SC3Pv3"
    # site file demanding >60% match makes the same data fail preflight
    p = tmp_path / "parameters.toml"
    p.write_text("min_fraction_whitelist_match = 0.6\n")
    monkeypatch.setenv(params.ENV_VAR, str(p))
    params.load(refresh=True)
    import pytest as _pytest
    with _pytest.raises(ValueError):
        detect_chemistry(r1, wls, candidates=("SC3Pv3",), n_sample=200)
    monkeypatch.delenv(params.ENV_VAR)
    params.load(refresh=True)


def test_run_with_retry_transient_vs_permanent():
    from cellranger_tpu.pipeline.runtime import run_with_retry
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("connection reset")
        return "ok"

    assert run_with_retry(flaky, retries=3, backoff_s=0.0) == "ok"
    assert calls["n"] == 3

    def config_error():
        raise ValueError("bad chemistry")

    import pytest as _p
    with _p.raises(ValueError):
        run_with_retry(config_error, retries=3, backoff_s=0.0)

    def always():
        raise RuntimeError("down")

    with _p.raises(RuntimeError):
        run_with_retry(always, retries=1, backoff_s=0.0)
