"""Multi-host startup and chain-redundancy helpers.

The reference is a single Julia process (SURVEY.md §2.6: no distributed
backend of any kind). Here multi-process runs use JAX's standard
bootstrap: every process calls `init_distributed()` with the coordinator's
address, the process count and its own id, builds the same global mesh
over `jax.devices()`, and the sharded sweep's psum/all_gather compile to
collectives (NCCL between GPUs) with no further code changes.

Not exercisable in CI (single host); the multi-chip schedule itself is
validated on the virtual CPU mesh (tests/test_sharded.py) and by the
driver's dryrun_multichip.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """jax.distributed.initialize with env-var fallbacks (COORDINATOR_ADDRESS
    / NUM_PROCESSES / PROCESS_ID). Returns True if a multi-process runtime
    was initialized, False for a single-process run (no coordinator and no
    process count given). Nothing is auto-detected: a cluster must be
    described."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(n_chains: int = 1, n_shards: Optional[int] = None):
    """A (chains, shards) mesh over ALL processes' devices. Chains ride the
    outer axis, so marker-shard psums stay within a host whenever
    n_shards <= devices-per-host."""
    from .sharded import make_mesh

    return make_mesh(n_chains, n_shards, devices=jax.devices())


def chain_checksum(state) -> float:
    """Deterministic scalar fingerprint of a chain state, for cross-host
    divergence detection (same seed + same sweep -> identical checksum on
    every host; SURVEY.md §4.6)."""
    leaves = jax.tree_util.tree_leaves(state)
    acc = 0.0
    for leaf in leaves:
        a = np.asarray(leaf, dtype=np.float64)
        if a.size:
            acc = float(np.sum(np.abs(a)) + acc * 1.000000119)
    return acc
