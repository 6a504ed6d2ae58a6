"""Regenerate the golden snapshot of the e2e fixture outputs.

The reference treats goldens as externally-produced truth
(cr_lib/src/testing/correctness.rs:24); regenerating ours alongside a
behavior change would gate nothing.  So regeneration REQUIRES a --reason,
and every regen appends the reason + a file-level diff summary to
tests/golden/e2e/CHANGELOG; tests/test_golden_changelog.py fails when
goldens changed in a commit without a matching CHANGELOG entry.

Run after an INTENTIONAL output change, review the diff, and commit:
    python tools/make_golden.py --reason "why the outputs changed and \
which oracle/spec test pins the new behavior"
"""

import argparse
import datetime
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax

from cellranger_tpu.compile_cache import enable_compile_cache

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()

GOLDEN_DIR = os.path.join(REPO, "tests", "golden", "e2e")

FILES = [
    "metrics_summary.json",
    "filtered_feature_bc_matrix.h5",
    "molecule_info.h5",
    "possorted_genome_bam.bam",
    "raw_feature_bc_matrix/matrix.mtx.gz",
    "raw_feature_bc_matrix/barcodes.tsv.gz",
    "raw_feature_bc_matrix/features.tsv.gz",
    "filtered_barcodes.csv",
    "junctions.tsv",
]


def _sha(path: str) -> str:
    if not os.path.exists(path):
        return "absent"
    return hashlib.sha256(open(path, "rb").read()).hexdigest()[:12]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reason", required=True,
                    help="why the outputs changed + which invariant "
                         "(oracle/spec test) pins the new behavior")
    args = ap.parse_args()
    if len(args.reason.strip()) < 20:
        ap.error("--reason must actually explain the change (>=20 chars)")

    import e2e_drive

    runs = [
        (GOLDEN_DIR,
         lambda: e2e_drive.run(tempfile.mkdtemp(prefix="cr_tpu_golden_"),
                               dryrun=False)),
        (os.path.join(REPO, "tests", "golden", "e2e_rich"),
         lambda: e2e_drive.run_rich(
             tempfile.mkdtemp(prefix="cr_tpu_goldenrich_"))),
    ]
    try:
        head = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True,
                              cwd=REPO).stdout.strip()
    except Exception:
        head = "unknown"
    for golden_dir, driver in runs:
        res = driver()
        out = res["out_dir"]
        os.makedirs(golden_dir, exist_ok=True)
        changed = []
        for rel in FILES:
            src = os.path.join(out, rel)
            dst = os.path.join(golden_dir, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            old = _sha(dst)
            shutil.copyfile(src, dst)
            new = _sha(dst)
            if old != new:
                changed.append(f"{rel}: {old} -> {new}")
            print("golden <-", rel,
                  "(changed)" if old != new else "(same)")
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M")
        with open(os.path.join(golden_dir, "CHANGELOG"), "a") as f:
            f.write(f"\n## {stamp} (parent {head})\n")
            f.write(f"reason: {args.reason.strip()}\n")
            if changed:
                f.write("changed files:\n")
                for c in changed:
                    f.write(f"  - {c}\n")
            else:
                f.write("changed files: none (byte-identical regen)\n")
        print("golden snapshot written to", golden_dir)
    print("CHANGELOG entries appended — commit them WITH the goldens")


if __name__ == "__main__":
    main()
