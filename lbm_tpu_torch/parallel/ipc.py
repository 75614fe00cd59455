"""The device transport: the pieces of an exchange that cross processes on
one host, moved from card to card through CUDA IPC, never through the host.

``lbm_tpu`` trades every halo piece between processes device to device
(``lax.ppermute``, ``lbm_tpu/parallel/sharded.py:89-95, 310-320``); on one
host the device's counterpart between processes is CUDA IPC, the transport
NCCL itself uses inside a node.  :class:`DeviceTransport` carries the
messages of a :class:`~lbm_tpu_torch.parallel.halo.SplitExchange`: one
message (:class:`Channel`) is this process's pieces of one phase to or
from one peer, in the global list's order.

* **Setup**, at the first exchange it carries (a collective: every process
  links the same exchanges in the same order): each process allocates one
  block of device memory (``lbm_ipc_malloc``, not torch's caching
  allocator, whose IPC handle would name a whole segment) that holds a
  mailbox for every message it receives, two parities each, and makes one
  inter-process event per message and parity for its sends and one for its
  receipts.  The handles go round once (``dist.all_gather_object``); each
  process maps its peers' blocks and opens their events.  A control block
  under ``/dev/shm``, named over the group and unlinked as soon as every
  process has mapped it, holds 64-bit sequence and acknowledgement
  counters per (source, destination, phase, parity).
* **A send** (message n, parity n % 2): once the peer has acknowledged
  message n - 2, this process's stream waits on the peer's receipt event of
  that parity (its unpack has run), the pack kernel writes the pieces into
  the peer's mailbox, the send event is recorded, and then the sequence
  counter is published.
* **A receive** waits on the host for the sequence counter, makes its
  stream wait on the peer's send event, unpacks on that stream, records its
  receipt event and publishes the acknowledgement.

No step synchronises the host with the card: the hosts trade counters
while the cards order the copies by events, so a process's host runs ahead
of its card as in one process.  An event is waited on only after the
counter published after its record, and re-recorded only after the peer
has acknowledged the wait, so no wait sees a stale record.  Every host wait
raises after ``timeout`` seconds, or as soon as the peer process is gone,
naming the peer and the pieces.  Waits are on the host and by event, never
by a kernel that polls: two processes without MPS time-slice the card, and
a spinning kernel would hold it for its whole slice.

On the CPU the same class runs its plain version: the mailboxes are CPU
tensors over ``/dev/shm`` files, pack and unpack are ``Tensor.copy_`` per
piece, and the counters alone order them (the copies are synchronous).

A failure to map a peer's block, open an event or launch a kernel raises:
nothing falls back to host staging.  The transport lives as long as its
program; :func:`lbm_tpu_torch.parallel.dist.shutdown` closes it: the peers'
blocks unmapped, a barrier, then its own freed.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import mmap
import os
import time

import numpy as np
import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops.fused import _launch, runs_plain
from lbm_tpu_torch.parallel import dist

# How long a host wait on a peer's counter lasts before it raises.
TIMEOUT_S = 120.0
PHASES = 2  # the y and x phases of a halo exchange (a ghost exchange has one)
PARITIES = 2  # mailboxes a message: the sender fills one while the other is read
ALIGN = 64  # floats: each mailbox starts on 256 bytes
SEQ, ACK = 0, 1  # the control block's two counters
SHM_DIR = "/dev/shm"
HANDLE_BYTES = 64  # CUDA_IPC_HANDLE_SIZE: an IPC memory or event handle
_CHECK_EVERY_S = 0.05  # between two looks at the deadline and the peer's process


@dataclasses.dataclass
class Channel:
    """One message: this process's pieces of one phase to (a send) or from
    (a receive) one peer, in the global list's order.  ``offsets`` are each
    piece's place in the message (floats); ``table`` is the pieces' device
    table (:func:`table_rows`) on their CUDA device, None on the CPU."""

    peer: int
    phase: int
    tags: list[int]
    views: list[torch.Tensor]
    offsets: list[int]
    numel: int
    table: torch.Tensor | None = None

    @classmethod
    def of(cls, peer: int, phase: int, messages) -> Channel:
        offsets, at = [], 0
        for m in messages:
            offsets.append(at)
            at += m.view.numel()
        views = [m.view for m in messages]
        dev = views[0].device
        if any(v.device != dev or v.dtype != torch.float32 or v.dim() != 3 for v in views):
            raise ValueError("a message's pieces must be 3-D float32 views on one device")
        table = None
        if dev.type == "cuda":
            rows = table_rows(views, offsets)
            table = torch.tensor(rows, dtype=torch.int64).to(dev)
        return cls(peer, phase, [m.tag for m in messages], views, offsets, at, table)

    @property
    def max_numel(self) -> int:
        return max(v.numel() for v in self.views)

    def describe(self) -> str:
        return f"phase {self.phase}, pieces {self.tags}"


def table_rows(views: list[torch.Tensor], offsets: list[int]) -> list[list[int]]:
    """The pack and unpack kernels' table (``PieceRow`` in
    ``csrc/lbm_ipc.cu``): per piece, its first element's address, its
    plane, row and column strides (floats), planes, rows, columns, and its
    offset in the mailbox (floats)."""
    rows = []
    for v, off in zip(views, offsets):
        if v.numel() >= 2**31:
            raise ValueError(f"a piece of {v.numel()} elements: at most 2**31 - 1")
        rows.append([v.data_ptr(), *v.stride(), *v.shape, off])
    return rows


def pack_plain(ch: Channel, mailbox: torch.Tensor) -> None:
    """The pack's plain version: each piece copied into its place."""
    for v, off in zip(ch.views, ch.offsets):
        mailbox[off:off + v.numel()].view(v.shape).copy_(v)


def unpack_plain(ch: Channel, mailbox: torch.Tensor) -> None:
    """The unpack's plain version: each piece copied out of its place."""
    for v, off in zip(ch.views, ch.offsets):
        v.copy_(mailbox[off:off + v.numel()].view(v.shape))


def _exchange_kernel(name: str, ch: Channel, mailbox: torch.Tensor) -> None:
    if mailbox.device != ch.views[0].device or mailbox.dtype != torch.float32:
        raise ValueError(f"{name}: the mailbox must be float32 on {ch.views[0].device}, "
                         f"got {mailbox.dtype} on {mailbox.device}")
    if not mailbox.is_contiguous() or mailbox.numel() < ch.numel:
        raise ValueError(f"{name}: a contiguous mailbox of {ch.numel} floats or more, got "
                         f"{mailbox.numel()}")
    stream = torch.cuda.current_stream(mailbox.device).cuda_stream
    _launch(_build.load_library(), name, ch.table.data_ptr(), len(ch.views), ch.max_numel,
            mailbox.data_ptr(), stream)


def exchange_pack(ch: Channel, mailbox: torch.Tensor) -> None:
    """``lbm_exchange_pack``: the channel's pieces into ``mailbox`` (float32,
    contiguous, on their device), one launch on the current stream; the
    plain version for CPU tensors."""
    if runs_plain(ch.views[0]):
        pack_plain(ch, mailbox)
    else:
        _exchange_kernel("lbm_exchange_pack", ch, mailbox)


def exchange_unpack(ch: Channel, mailbox: torch.Tensor) -> None:
    """``lbm_exchange_unpack``: ``mailbox`` into the channel's pieces, one
    launch on the current stream; the plain version for CPU tensors."""
    if runs_plain(ch.views[0]):
        unpack_plain(ch, mailbox)
    else:
        _exchange_kernel("lbm_exchange_unpack", ch, mailbox)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        lib = _build.load_library()
        raise RuntimeError(f"{what} failed: {lib.lbm_error_string(rc).decode()}")


def _out_pointer(fn, *args) -> int:
    """``fn(*args, &out)`` for a C function that returns a pointer through
    its last argument; raises on an error code."""
    out = ctypes.c_void_p()
    _check(fn(*args, ctypes.addressof(out)), fn.__name__)
    return out.value


def _handle(fn, obj) -> bytes:
    """The IPC handle of a device block or event (``fn(obj, &handle)``)."""
    buf = ctypes.create_string_buffer(HANDLE_BYTES)
    _check(fn(obj, ctypes.addressof(buf)), fn.__name__)
    return buf.raw


class _DevicePointer:
    """A float32 vector at a device address, for ``torch.as_tensor``."""

    def __init__(self, ptr: int, numel: int) -> None:
        self.__cuda_array_interface__ = {"shape": (numel,), "typestr": "<f4",
                                         "data": (ptr, False), "strides": None,
                                         "version": 2}


def _shm_map(path: str, nbytes: int, create: bool) -> mmap.mmap:
    flags = os.O_RDWR | (os.O_CREAT if create else 0)
    fd = os.open(path, flags, 0o600)
    try:
        if create:
            os.ftruncate(fd, nbytes)
        return mmap.mmap(fd, nbytes)
    finally:
        os.close(fd)


def _alive(pid: int) -> bool:
    """Whether process ``pid`` runs (a zombie does not); True where
    ``/proc`` cannot say."""
    if not os.path.exists("/proc/self/stat"):
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rpartition(")")[2].split()[0]
    except (OSError, IndexError):
        return False
    return state not in ("Z", "X")


class DeviceTransport:
    """The pieces of exchanges that cross processes, on this host, through
    mailboxes in the receivers' memory (see the module docstring).  One
    transport carries every exchange of one program, on ``device``: a
    CUDA device (IPC), or the CPU (the plain version).  ``link(phases)``
    is what :class:`~lbm_tpu_torch.parallel.halo.SplitExchange` calls; the
    first link sets the transport up over the group."""

    def __init__(self, device, rank: int | None = None, timeout: float = TIMEOUT_S) -> None:
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.rank = dist.process_index() if rank is None else rank
        self.timeout = timeout
        self.sizes: dict | None = None  # ("send" | "recv", peer, phase) -> floats
        self._sent: collections.Counter = collections.Counter()
        self._received: collections.Counter = collections.Counter()
        self._closed = False

    def _guard(self):
        return torch.cuda.device(self.device) if self.cuda else contextlib.nullcontext()

    def _stream(self) -> int | None:
        return torch.cuda.current_stream(self.device).cuda_stream if self.cuda else None

    def link(self, phases) -> _DeviceLink:
        """The channels of an exchange's phases (``SplitExchange.phases``),
        each phase's sends and receives grouped by peer; sets the transport
        up at the first link, and raises where a later one's messages differ
        in size from the first's."""
        link = _DeviceLink(self, phases)
        sizes = {(kind, ch.peer, ch.phase): ch.numel
                 for kind, chans in (("send", link.sends), ("recv", link.recvs))
                 for per_phase in chans for ch in per_phase}
        if self.sizes is None:
            self._open(sizes)
        elif sizes != self.sizes:
            raise ValueError(f"an exchange of other messages {sizes} on a transport set up "
                             f"for {self.sizes}")
        return link

    # -- setup and teardown ---------------------------------------------

    def _open(self, sizes: dict) -> None:
        if not os.path.isdir(SHM_DIR):
            raise RuntimeError(f"the device transport needs {SHM_DIR} (host shared memory)")
        lib = _build.load_library() if self.cuda else None
        procs, me = dist.process_count(), self.rank
        name = dist.channel_name("ipc")
        # The receive mailboxes: one region a (peer, phase, parity).
        layout, total = {}, 0
        for (kind, peer, phase), n in sorted(sizes.items()):
            if kind == "recv":
                for q in range(PARITIES):
                    layout[(peer, phase, q)] = (total, n)
                    total += -(-n // ALIGN) * ALIGN
        total = max(total, ALIGN)
        ctl_path = os.path.join(SHM_DIR, name)
        ctl_bytes = 2 * procs * procs * PHASES * PARITIES * 8
        self._ctl_map = _shm_map(ctl_path, ctl_bytes, create=True)
        self._ctl = np.frombuffer(self._ctl_map, dtype=np.int64).reshape(
            2, procs, procs, PHASES, PARITIES)
        self._own_events: dict = {}
        self._peer_events: dict = {}
        self._peer_blocks: dict = {}
        with self._guard():
            if self.cuda:
                self._block = _out_pointer(lib.lbm_ipc_malloc, total)
                block_handle = _handle(lib.lbm_ipc_mem_handle, self._block)
                for (kind, peer, phase) in sizes:
                    for q in range(PARITIES):
                        self._own_events[(kind, peer, phase, q)] = _out_pointer(
                            lib.lbm_ipc_event_create)
                event_handles = {key: _handle(lib.lbm_ipc_event_handle, ev)
                                 for key, ev in self._own_events.items()}
                self._own_box = torch.as_tensor(_DevicePointer(self._block, total),
                                                device=self.device)
            else:
                block_handle = os.path.join(SHM_DIR, f"{name}.r{me}")
                self._block = _shm_map(block_handle, total * 4, create=True)
                event_handles = {}
                self._own_box = torch.frombuffer(self._block, dtype=torch.float32)
            everyone = dist.all_gather_object({
                "pid": os.getpid(), "layout": layout, "block": block_handle,
                "floats": total, "events": event_handles})
            self._pids = [e["pid"] for e in everyone]
            self._own_slots = {key: self._own_box[off:off + n]
                               for key, (off, n) in layout.items()}
            self._peer_slots = {}
            for (kind, peer, phase), n in sizes.items():
                if kind != "send":
                    continue
                theirs = everyone[peer]
                if theirs["layout"].get((me, phase, 0), (0, None))[1] != n:
                    raise RuntimeError(
                        f"process {me} sends {n} floats in phase {phase} to process {peer}, "
                        f"which expects {theirs['layout'].get((me, phase, 0))}")
                box = self._map_peer(peer, theirs, lib)
                for q in range(PARITIES):
                    off, _ = theirs["layout"][(me, phase, q)]
                    self._peer_slots[(peer, phase, q)] = box[off:off + n]
            if self.cuda:
                # A send waits on the peer's receipt event, a receive on the
                # peer's send event.
                for (kind, peer, phase) in sizes:
                    other = "recv" if kind == "send" else "send"
                    for q in range(PARITIES):
                        handle = everyone[peer]["events"][(other, me, phase, q)]
                        buf = ctypes.create_string_buffer(handle, len(handle))
                        self._peer_events[(kind, peer, phase, q)] = _out_pointer(
                            lib.lbm_ipc_event_open, ctypes.addressof(buf))
        dist.barrier("ipc setup")
        # Every process has mapped the files: their names can go.
        if not self.cuda:
            os.unlink(block_handle)
        if me == 0:
            os.unlink(ctl_path)
        self.sizes = sizes
        dist.on_shutdown(self.close)

    def _map_peer(self, peer: int, theirs: dict, lib) -> torch.Tensor:
        """A peer's whole receive block (``theirs``: its gathered setup),
        mapped once."""
        if peer not in self._peer_blocks:
            if self.cuda:
                buf = ctypes.create_string_buffer(theirs["block"], len(theirs["block"]))
                block = _out_pointer(lib.lbm_ipc_open_mem, ctypes.addressof(buf))
                box = torch.as_tensor(_DevicePointer(block, theirs["floats"]),
                                      device=self.device)
            else:
                block = _shm_map(theirs["block"], theirs["floats"] * 4, create=False)
                box = torch.frombuffer(block, dtype=torch.float32)
            self._peer_blocks[peer] = (block, box)
        return self._peer_blocks[peer][1]

    def close(self) -> None:
        """Unmap the peers' blocks and close their events, wait for every
        process to have done so, then free this process's own (a
        collective; nothing after the first call)."""
        if self._closed or self.sizes is None:
            self._closed = True
            return
        self._closed = True
        lib = _build.load_library() if self.cuda else None
        with self._guard():
            if self.cuda:
                torch.cuda.current_stream(self.device).synchronize()
            self._peer_slots = self._own_slots = self._own_box = None
            blocks = [block for block, _ in self._peer_blocks.values()]
            self._peer_blocks = {}
            for block in blocks:
                if self.cuda:
                    _check(lib.lbm_ipc_close_mem(block), "lbm_ipc_close_mem")
                else:
                    _close_map(block)
            for ev in self._peer_events.values():
                _check(lib.lbm_ipc_event_destroy(ev), "lbm_ipc_event_destroy")
            self._peer_events = {}
            dist.barrier("ipc close")
            if self.cuda:
                _check(lib.lbm_ipc_free(self._block), "lbm_ipc_free")
                for ev in self._own_events.values():
                    _check(lib.lbm_ipc_event_destroy(ev), "lbm_ipc_event_destroy")
            else:
                _close_map(self._block)
            self._block, self._own_events = None, {}
        self._ctl = None
        _close_map(self._ctl_map)

    # -- the protocol ----------------------------------------------------

    def _await(self, kind: int, idx: tuple, n: int, ch: Channel, what: str) -> None:
        """Wait on the host until counter ``kind`` at ``idx`` reaches ``n``;
        raise after ``timeout`` s or once the peer process is gone."""
        ctl = self._ctl[kind]
        if ctl[idx] >= n:
            return
        deadline = time.monotonic() + self.timeout
        check = time.monotonic() + _CHECK_EVERY_S
        while ctl[idx] < n:
            now = time.monotonic()
            if now >= check:
                check = now + _CHECK_EVERY_S
                gone = not _alive(self._pids[ch.peer])
                if (gone or now > deadline) and ctl[idx] < n:
                    why = ("has exited" if gone else
                           f"sent nothing for {self.timeout:g} s")
                    raise TimeoutError(
                        f"process {self.rank}: waiting for {what} {n} ({ch.describe()}) "
                        f"of process {ch.peer} (pid {self._pids[ch.peer]}), which {why}")
            os.sched_yield()

    def send(self, ch: Channel, stream) -> None:
        n = self._sent[(ch.peer, ch.phase)] + 1
        q = n % PARITIES
        if n > PARITIES:  # the peer's unpack of message n - 2 has run
            self._await(ACK, (self.rank, ch.peer, ch.phase, q), n - PARITIES, ch,
                        "the receipt of message")
            if self.cuda:
                self._wait(stream, self._peer_events[("send", ch.peer, ch.phase, q)])
        exchange_pack(ch, self._peer_slots[(ch.peer, ch.phase, q)])
        if self.cuda:
            self._record(self._own_events[("send", ch.peer, ch.phase, q)], stream)
        self._ctl[SEQ, self.rank, ch.peer, ch.phase, q] = n
        self._sent[(ch.peer, ch.phase)] = n

    def receive(self, ch: Channel, stream) -> None:
        n = self._received[(ch.peer, ch.phase)] + 1
        q = n % PARITIES
        self._await(SEQ, (ch.peer, self.rank, ch.phase, q), n, ch, "message")
        if self.cuda:
            self._wait(stream, self._peer_events[("recv", ch.peer, ch.phase, q)])
        exchange_unpack(ch, self._own_slots[(ch.peer, ch.phase, q)])
        if self.cuda:
            self._record(self._own_events[("recv", ch.peer, ch.phase, q)], stream)
        self._ctl[ACK, ch.peer, self.rank, ch.phase, q] = n
        self._received[(ch.peer, ch.phase)] = n

    @staticmethod
    def _wait(stream: int, event: int) -> None:
        _check(_build.load_library().lbm_ipc_stream_wait(stream, event),
               "lbm_ipc_stream_wait")

    @staticmethod
    def _record(event: int, stream: int) -> None:
        _check(_build.load_library().lbm_ipc_event_record(event, stream),
               "lbm_ipc_event_record")


class _DeviceLink:
    """One exchange's channels on a :class:`DeviceTransport`:
    ``sends[i]`` and ``recvs[i]``, phase ``i``'s channels by peer."""

    def __init__(self, transport: DeviceTransport, phases) -> None:
        self.transport = transport
        self.sends = [channels(ph.number, ph.sends) for ph in phases]
        self.recvs = [channels(ph.number, ph.recvs) for ph in phases]

    def start(self, i: int) -> None:
        t = self.transport
        with t._guard():
            stream = t._stream()
            for ch in self.sends[i]:
                t.send(ch, stream)

    def finish(self, i: int) -> None:
        t = self.transport
        with t._guard():
            stream = t._stream()
            for ch in self.recvs[i]:
                t.receive(ch, stream)


def channels(phase: int, messages) -> list[Channel]:
    """One phase's messages (``SplitExchange`` sends or receives, in tag
    order) as one channel a peer."""
    by_peer: dict[int, list] = {}
    for m in messages:
        by_peer.setdefault(m.peer, []).append(m)
    return [Channel.of(peer, phase, ms) for peer, ms in sorted(by_peer.items())]


def _close_map(m: mmap.mmap) -> None:
    """Unmap now where nothing else views the mapping, else at collection."""
    try:
        m.close()
    except BufferError:
        pass
