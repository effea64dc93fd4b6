"""Cross-process result collection for a distributed evaluation.

Counterpart of ``panacea_tpu/perception/collect.py`` (reference
core/apis/test.py:45-163 ``collect_results_cpu``): every process pickles its
shard of results into a shared directory, the processes meet at a barrier,
and rank 0 merges the shards back into dataset order. The barrier is
``torch.distributed.barrier`` where a process group is initialised, and none
otherwise (one process: nothing to wait for).
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional, Tuple


def _default_barrier(name: str) -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def collect_results_cpu(
    indexed_results: List[Tuple[int, Dict]],
    tmpdir: str,
    rank: int,
    world_size: int,
    barrier: Optional[Callable[[str], None]] = None,
) -> Optional[List[Dict]]:
    """Gather per-process ``(dataset_index, result)`` shards.

    Returns the merged, index-sorted result list on rank 0 and ``None`` on
    the other ranks (only rank 0 computes metrics, core/apis/test.py:116-163).
    ``barrier`` is injectable for single-process multi-rank tests.
    """
    barrier = barrier or _default_barrier
    if world_size == 1:
        return [r for _, r in sorted(indexed_results, key=lambda x: x[0])]

    os.makedirs(tmpdir, exist_ok=True)
    with open(os.path.join(tmpdir, f"part_{rank}.pkl"), "wb") as f:
        pickle.dump(indexed_results, f)
    barrier("collect_results_write")
    if rank != 0:
        # writers must not race rank 0's cleanup
        barrier("collect_results_read")
        return None

    merged: List[Tuple[int, Dict]] = []
    for r in range(world_size):
        path = os.path.join(tmpdir, f"part_{r}.pkl")
        with open(path, "rb") as f:
            merged.extend(pickle.load(f))
        os.remove(path)
    barrier("collect_results_read")
    return [res for _, res in sorted(merged, key=lambda x: x[0])]
