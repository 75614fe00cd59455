"""The process group of a sharded run that spans processes.

The counterpart of ``jax.distributed.initialize`` and of
``jax.process_index`` / ``jax.process_count``: a mesh may span
``torch.distributed`` processes, each of which drives only the shards it
owns (:meth:`lbm_tpu_torch.parallel.mesh.Mesh.local_positions`) and trades
halo rows with the others over the group.  The backend is gloo on every
device: its point-to-point operations take host tensors, so the exchange
stages a CUDA shard's rows through pinned host buffers
(:class:`lbm_tpu_torch.parallel.halo.HaloExchange`).

Nothing here starts a group behind the caller's back: without
:func:`initialize`, :func:`process_index` is 0, :func:`process_count` is 1
and every mesh lives in this one process.  A peer that dies or a failed
send raises from the collective that waits on it.
"""

from __future__ import annotations

import datetime

import torch.distributed as tdist

# How long a collective or a receive waits for a peer before it raises.
TIMEOUT = datetime.timedelta(seconds=300)


def initialize(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join the gloo group of ``num_processes`` processes as ``process_id``;
    ``coordinator_address`` is ``host:port`` of process 0's rendezvous
    (``tcp://`` init).  Raises if this process is in a group already."""
    if tdist.is_initialized():
        raise RuntimeError("this process is in a process group already")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    tdist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                             world_size=num_processes, rank=process_id, timeout=TIMEOUT)


def initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def process_index() -> int:
    """This process's rank, 0 without a group."""
    return tdist.get_rank() if initialized() else 0


def process_count() -> int:
    """The processes of the group, 1 without one."""
    return tdist.get_world_size() if initialized() else 1


def barrier(name: str) -> None:
    """Wait for every process of the group (nothing without one); ``name``
    says which barrier timed out or lost a peer."""
    if not initialized():
        return
    try:
        tdist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} on process {process_index()}: {e}") from e


def all_gather_object(obj) -> list:
    """Every process's picklable ``obj``, by rank; ``[obj]`` without a group."""
    if not initialized():
        return [obj]
    out = [None] * process_count()
    tdist.all_gather_object(out, obj)
    return out


def shutdown() -> None:
    """Leave the group (nothing without one)."""
    if initialized():
        tdist.destroy_process_group()
