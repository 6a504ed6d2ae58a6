"""One compile cache: JAX_COMPILATION_CACHE_DIR when set, else a fixed
directory under the checkout."""

import os

import jax

from cellranger_tpu import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_environment_variable_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv(cc.ENV, str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert cc.enable_compile_cache() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_default_is_fixed_under_the_checkout(monkeypatch):
    monkeypatch.delenv(cc.ENV, raising=False)
    calls = _record_updates(monkeypatch)
    want = os.path.join(REPO, ".jax_cache")
    assert cc.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_host_only_cli_commands_leave_the_cache_alone(monkeypatch, tmp_path):
    from cellranger_tpu import cli
    monkeypatch.delenv(cc.ENV, raising=False)
    calls = _record_updates(monkeypatch)
    gtf = tmp_path / "in.gtf"
    gtf.write_text('chr1\tx\texon\t1\t10\t.\t+\t.\tgene_id "G"; '
                   'gene_biotype "protein_coding";\n')
    cli.main(["mkgtf", str(gtf), str(tmp_path / "out.gtf"),
              "--attribute", "gene_biotype:protein_coding"])
    assert calls == [] and "mkgtf" in cli.HOST_ONLY_COMMANDS
