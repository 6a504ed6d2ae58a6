"""Multi-host scale-out plumbing (jax.distributed).

The reference scales out by having mrp schedule stage chunks across a
cluster with a shared filesystem (SURVEY §2.7 P7, lib/rust/cr_wrap/src/
mrp_args.rs:5-65).  The JAX analog: one Python process per host, joined
into a single JAX runtime via `jax.distributed.initialize`, a global mesh
spanning every host's devices, and

  * FASTQ chunks data-parallel BY HOST (each host streams only its own
    subset of the input pairs — the MAKE_SHARD chunk fan-out analog),
  * psum/all-gather merges over the in-host interconnect and the network
    across hosts
    (metric joins, the pass-1 whitelist histogram),
  * molecule spill partitions written under the shared output directory
    and read back by host 0 for dedup + output writing (the shardio
    shared-filesystem exchange, barcode_sort.rs:97-113).

Single-host runs never touch this module's state: `init_from_env` is a
no-op unless the coordinator env vars are set, and `process_index/count`
fall back to (0, 1).
"""

from __future__ import annotations

import os

import jax

# Environment contract (set by the launcher on every host):
#   CRTPU_COORDINATOR    host:port of process 0
#   CRTPU_NUM_PROCESSES  total process count
#   CRTPU_PROCESS_ID     this process's id (0-based)
#   CRTPU_LOCAL_DEVICES  optional comma-separated local device ids this
#                        process opens (one process per card on a host);
#                        unset, the process opens every local device
ENV_COORD = "CRTPU_COORDINATOR"
ENV_NPROC = "CRTPU_NUM_PROCESSES"
ENV_PID = "CRTPU_PROCESS_ID"
ENV_LOCAL = "CRTPU_LOCAL_DEVICES"


def local_device_ids() -> list[int] | None:
    """This process's local device ids from CRTPU_LOCAL_DEVICES, or None."""
    v = os.environ.get(ENV_LOCAL, "").strip()
    return [int(x) for x in v.split(",")] if v else None

_initialized = False


def init_from_env() -> bool:
    """Initialize jax.distributed from CRTPU_* env vars; returns True when
    a multi-host runtime was brought up (idempotent, no-op without env)."""
    global _initialized
    if _initialized:
        return True
    coord = os.environ.get(ENV_COORD)
    if not coord:
        return False
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ[ENV_NPROC]),
        process_id=int(os.environ[ENV_PID]),
        local_device_ids=local_device_ids())
    _initialized = True
    return True


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


def host_shard(items: list, pid: int | None = None,
               nproc: int | None = None) -> list:
    """Deterministic round-robin assignment of work items (FASTQ pairs) to
    hosts: host k takes items k, k+n, k+2n, ...  Round-robin (not block)
    keeps read mass balanced when pair sizes vary monotonically (lane
    ordering)."""
    pid = process_index() if pid is None else pid
    nproc = process_count() if nproc is None else nproc
    return items[pid::nproc]


def allsum_array(x):
    """Element-wise sum of a host-local array across all hosts (the single
    cross-host collective of pass 1: the whitelist histogram merge)."""
    import numpy as np
    if process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(
        multihost_utils.process_allgather(np.asarray(x))).sum(axis=0)


def barrier(name: str = "sync"):
    """Block until every host reaches this point (spill handoff fence)."""
    if process_count() == 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)
