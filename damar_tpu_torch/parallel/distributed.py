"""Host-side partition of the block-pair job matrix across hosts (the
two planning functions of damar_tpu.parallel.distributed; the ring sweep
over devices is not ported yet)."""
from __future__ import annotations


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
