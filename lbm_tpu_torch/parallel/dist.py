"""The process group of a sharded run that spans processes.

The counterpart of ``jax.distributed.initialize`` and of
``jax.process_index`` / ``jax.process_count``: a mesh may span
``torch.distributed`` processes, each of which drives only the shards it
owns (:meth:`lbm_tpu_torch.parallel.mesh.Mesh.local_positions`) and trades
halo rows with the others.  The group's backend is gloo on every device:
it carries the collectives, and the halo pieces where the processes span
hosts or drive CPU shards (staged through pinned host buffers for CUDA
shards, :class:`lbm_tpu_torch.parallel.halo.HaloExchange`).  Processes of
one host with CUDA shards trade their pieces card to card
(:mod:`lbm_tpu_torch.parallel.ipc`), set up over the group with
:func:`hostnames` and :func:`channel_name`.

Nothing here starts a group behind the caller's back: without
:func:`initialize`, :func:`process_index` is 0, :func:`process_count` is 1
and every mesh lives in this one process.  A peer that dies or a failed
send raises from the collective that waits on it.
"""

from __future__ import annotations

import datetime
import secrets
import socket

import torch.distributed as tdist

# How long a collective or a receive waits for a peer before it raises.
TIMEOUT = datetime.timedelta(seconds=300)

_hostnames: list[str] | None = None
_closers: list = []  # what shutdown closes first, in reverse order


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


def hostnames() -> list[str]:
    """Every process's host name, by rank (gathered once a group)."""
    global _hostnames
    if _hostnames is None:
        _hostnames = all_gather_object(socket.gethostname())
    return _hostnames


def channel_name(tag: str) -> str:
    """A name for a shared-memory object of ``tag``, the same on every
    process of the group and new each call (process 0's random token)."""
    return f"lbm_tpu_torch.{tag}.{all_gather_object(secrets.token_hex(8))[0]}"


def on_shutdown(close) -> None:
    """Have :func:`shutdown` call ``close()`` before it leaves the group
    (the last registered first): a collective, on every process."""
    _closers.append(close)


def shutdown() -> None:
    """Close what :func:`on_shutdown` registered, then leave the group
    (nothing without one)."""
    global _hostnames
    while _closers:
        _closers.pop()()
    _hostnames = None
    if initialized():
        tdist.destroy_process_group()
