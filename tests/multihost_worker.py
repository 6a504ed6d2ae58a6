"""Subprocess entry for the 2-process multihost integration test: joins the
jax.distributed runtime on CPU (CRTPU_* env contract,
parallel/distributed.py) and runs the production run_count over a shared
output directory — host 0 writes the joined outputs, workers publish spill
partials (the mrp chunk/join analog, cr_wrap/src/mrp_args.rs:5-65).

Usage: python multihost_worker.py <cfg.json> <out_dir>
(env CRTPU_COORDINATOR/CRTPU_NUM_PROCESSES/CRTPU_PROCESS_ID must be set)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")  # CPU even where a GPU is present

# the distributed runtime must come up BEFORE anything touches the XLA
# backend (jax.distributed.initialize contract) — i.e. before the heavy
# package imports, exactly as a production launcher would sequence it
from cellranger_tpu.parallel import distributed as dist  # noqa: E402

dist.init_from_env()


def main():
    cfg_path, out_dir = sys.argv[1], sys.argv[2]
    with open(cfg_path) as f:
        d = json.load(f)
    from cellranger_tpu.pipeline.count import CountConfig, run_count
    cfg = CountConfig(**{k: (v if k != "fastq_pairs" else
                             [tuple(p) for p in v])
                         for k, v in d.items()})
    s = run_count(cfg, out_dir)
    print(json.dumps({"pid": int(os.environ["CRTPU_PROCESS_ID"]),
                      "total_reads": s.get("total_reads", 0)}))


if __name__ == "__main__":
    main()
