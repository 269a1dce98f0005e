"""Multi-process object collectives: the host-payload demo scripts' analog.

Counterpart of ``leetcuda_tpu/parallel/multihost.py``. These are
process-level, as in JAX: every process of a ``torch.distributed`` process
group contributes and receives host objects through
``broadcast_object_list``, ``all_gather_object`` and ``barrier`` (pickle
plus a tensor collective, what JAX's version does by hand). With no process
group initialised they take the one-process case, as JAX's does with one
process: gather returns [obj], broadcast is the identity, the barrier
returns at once. A process group is the caller's to set up
(``torch.distributed.init_process_group`` with its address, world size and
rank: gloo on the CPU, NCCL across GPUs).

    python -m leetcuda_tpu_torch.parallel.multihost

runs the two demos in one process, or in each process of a group set up
from the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from leetcuda_tpu_torch.parallel.mesh import Mesh, unshard


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _grouped() else 0


def process_count() -> int:
    return dist.get_world_size() if _grouped() else 1


def broadcast_object(obj, is_source: bool | None = None):
    """test_broadcast.py object-mode analog: the source process's object on
    every process. ``is_source`` defaults to process_index() == 0; exactly
    one process may be the source."""
    if is_source is None:
        is_source = process_index() == 0
    if not _grouped():
        return obj
    sources = all_gather_objects(bool(is_source))
    if sources.count(True) != 1:
        raise ValueError(f"broadcast_object: {sources.count(True)} source "
                         "processes, need exactly one")
    box = [obj if is_source else None]
    dist.broadcast_object_list(box, src=sources.index(True))
    return box[0]


def all_gather_objects(obj) -> list:
    """test_all_gather_objects.py analog: every process's object, in process
    order, on every process."""
    if not _grouped():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def sync_processes(name: str = "barrier"):
    """dist.barrier() analog (``name`` labels it, as JAX's does)."""
    if _grouped():
        dist.barrier()


def host_local_to_global(pieces, mesh: Mesh, spec):
    """The array-assembly step: the ranks' pieces (in mesh order, as
    ``mesh.shard`` gives them) become one array laid out by ``spec``, on the
    first rank's device. Under the port's single-controller model one
    process holds every rank's piece."""
    return unshard(pieces, mesh, spec)


def _local_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def demo_all_gather_objects(verbose: bool = True):
    """Each process contributes a dict keyed by its rank."""
    rank = process_index()
    obj = {"rank": rank, "payload": [rank, f"host-{rank}"],
           "devices": _local_devices()}
    out = all_gather_objects(obj)
    if verbose:
        print(f"[process {rank}] gathered objects: {out}")
    return out


def demo_broadcast_object(verbose: bool = True):
    obj = ({"config": {"lr": 3e-4, "steps": 1000}, "from": process_index()}
           if process_index() == 0 else None)
    out = broadcast_object(obj)
    if verbose:
        print(f"[process {process_index()}] broadcast -> {out}")
    return out


if __name__ == "__main__":
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group("gloo")
    demo_broadcast_object()
    demo_all_gather_objects()
    sync_processes()
    print(f"multihost demos ok (processes={process_count()})")
    if _grouped():
        dist.destroy_process_group()
