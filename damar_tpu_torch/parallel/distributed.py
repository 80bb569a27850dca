"""Host-side partition of the block-pair job matrix across hosts, and the
launcher contract that gives a host its index (the planning functions
and init_multihost of damar_tpu.parallel.distributed; the ring sweep over
devices is not ported yet)."""
from __future__ import annotations

import os


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> int:
    """This host's index in a multi-host run, from the launcher contract
    of a SLURM-style array: JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
    JAX_PROCESS_ID when the arguments are omitted (the variables
    damar_tpu reads, so one array script serves both packages).  Returns
    0 when no coordinator is set, so callers can be launcher-agnostic.

    No collective is initialized: the block sweep's hosts meet only
    through the shared filesystem (host_pair_slice), so the index is all
    they need.  num_hosts gives the count from the same contract."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return 0
    n = num_hosts(num_processes)
    pid = int(process_id if process_id is not None
              else os.environ.get("JAX_PROCESS_ID", "0"))
    if not 0 <= pid < n:
        raise ValueError(f"process id {pid} not in [0, {n})")
    return pid


def num_hosts(num_processes: int | None = None) -> int:
    """The host count of the launcher contract (JAX_NUM_PROCESSES,
    default 1)."""
    return int(num_processes or os.environ.get("JAX_NUM_PROCESSES", "1"))


def block_pair_matrix(nblocks: int) -> list[tuple[int, int]]:
    """The HPC.daligner job matrix: all unordered block pairs (i <= j),
    i.e. N(N+1)/2 comparisons."""
    return [(i, j) for i in range(1, nblocks + 1)
            for j in range(i, nblocks + 1)]


def host_pair_slice(nblocks: int, nhosts: int, host_id: int
                    ) -> list[tuple[int, int]]:
    """Deterministic partition of the block-pair matrix across hosts:
    pairs are dealt round-robin in matrix order, so every host gets an
    equal mix of self and distinct pairs.  The union over hosts is the
    full matrix and the slices are disjoint.  The shared filesystem is
    the only rendezvous: each host writes its pairs' .las files and marks
    the manifest, and any host (or a later rerun) merges once every pair
    of a block is done."""
    if not (0 <= host_id < nhosts):
        raise ValueError(f"host_id {host_id} not in [0, {nhosts})")
    return block_pair_matrix(nblocks)[host_id::nhosts]
