"""Checkpoint / resume, the port of ``lbm_tpu.checkpoint``.

A run can snapshot its full resumable state: the distributions ``f``
(which are the complete physical state), the step index and the av_vels
collected so far, and continue from it.  The files are ``lbm_tpu``'s, byte
for byte in layout, so either package resumes the other's snapshot:

* **v1 (single device)**: one ``.npz`` with a JSON header carrying the
  params and an obstacle-mask digest, so that a resume against the wrong
  case fails loudly.  Written to a temporary name and renamed into place
  (the commit point); stale files are pruned after the commit.
* **v2 (sharded)**: one ``.npz`` per shard, named by its coordinates and
  written by the process that owns it, ``lbm_checkpoint.av.npz`` and a
  meta JSON written last by process 0 as the commit point
  (:func:`save_sharded`); :func:`load` reassembles the global f on the
  host from every process's files in the shared directory, so a sharded
  snapshot resumes on any mesh, over any number of processes or on one
  card, in either package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib

import numpy as np

from lbm_tpu_torch.config import LBMParams
from lbm_tpu_torch.parallel import dist

FILENAME = "lbm_checkpoint.npz"
META_FILENAME = "lbm_checkpoint.meta.json"
AV_FILENAME = "lbm_checkpoint.av.npz"


def _mask_digest(obstacles: np.ndarray) -> str:
    return hashlib.sha256(np.packbits(np.asarray(obstacles, bool))).hexdigest()


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    params: LBMParams
    step: int  # timesteps already completed
    f: np.ndarray  # [9, ny, nx] float32
    av_vels: np.ndarray  # [step] float32
    mask_digest: str

    def validate(self, params: LBMParams, obstacles: np.ndarray) -> None:
        if (params.nx, params.ny) != (self.params.nx, self.params.ny):
            raise ValueError(
                f"checkpoint grid {self.params.shape} != run grid {params.shape}"
            )
        # Physics must match too, or a resume silently splices two
        # simulations into one trajectory (max_iters and reynolds_dim may
        # differ: they do not enter the dynamics).
        for field in ("density", "accel", "omega"):
            stored, now = getattr(self.params, field), getattr(params, field)
            if stored != now:
                raise ValueError(
                    f"checkpoint {field}={stored} != this run's {field}={now}"
                )
        if _mask_digest(obstacles) != self.mask_digest:
            raise ValueError("checkpoint obstacle mask differs from this run's")


def _av_prefix(av_vels, step: int) -> np.ndarray:
    """The av entries the snapshot commits.  Every step up to the committed
    one must have its entry: a shorter stream would make a later resume
    shift av rows off their timestep."""
    av = np.asarray(av_vels, np.float32)
    if av.shape[0] < step:
        raise ValueError(
            f"av_vels has {av.shape[0]} entries but the checkpoint "
            f"commits step {step} — refusing to write an inconsistent "
            "snapshot"
        )
    return av[:step]


def _prune_stale(directory: pathlib.Path, keep: set[str]) -> None:
    """Remove every ``lbm_checkpoint*`` file not in the committed set,
    strictly after the commit rename: a crash in here only leaves extra
    files.  The prefix match also collects ``*.tmp`` staging files of an
    earlier crashed save.  A run owns its checkpoint directory."""
    for p in directory.glob("lbm_checkpoint*"):
        if p.name not in keep and p.is_file():
            p.unlink(missing_ok=True)


def save(
    directory: str | pathlib.Path,
    params: LBMParams,
    obstacles: np.ndarray,
    step: int,
    f: np.ndarray,
    av_vels: np.ndarray,
) -> pathlib.Path:
    """Atomically write a v1 checkpoint into ``directory``."""
    av = _av_prefix(av_vels, int(step))
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / FILENAME
    tmp = path.with_suffix(".tmp.npz")
    header = json.dumps(
        {
            "params": dataclasses.asdict(params),
            "step": int(step),
            "mask_digest": _mask_digest(obstacles),
            "version": 1,
        }
    )
    with open(tmp, "wb") as fp:
        np.savez(
            fp,
            header=np.frombuffer(header.encode(), dtype=np.uint8),
            f=np.asarray(f, np.float32),
            av_vels=av,
        )
    tmp.replace(path)
    # A v2 set alongside is now stale (load() resolves v1 against v2 by
    # committed step, so a crash before this prune still resumes the
    # newer v1).
    _prune_stale(directory, keep={FILENAME})
    return path


def _shard_filename(step: int, y0: int, x0: int) -> str:
    """Coordinate-keyed shard filename (``lbm_tpu``'s: unique across the
    processes of a multi-host mesh)."""
    return f"lbm_checkpoint.step{step}.shard.y{y0}.x{x0}.npz"


def save_sharded(
    directory: str | pathlib.Path,
    params: LBMParams,
    obstacles: np.ndarray,
    step: int,
    f,
    av_vels: np.ndarray,
) -> pathlib.Path:
    """Snapshot f per shard, with no global gather (``lbm_tpu``'s
    ``save_sharded``): ``f`` is a sharded state, whose ``shards()`` yields
    ``(y0, x0, slab [9, ylen, xlen])`` per shard of this process and whose
    ``positions`` list ``(y0, x0, shape)`` of every shard of the mesh, or
    one host array ``[9, ny, nx]`` (one shard).  Each slab goes to its own
    step-stamped, coordinate-keyed ``.npz`` (written to a temporary name
    of this process, ``.tmp{rank}``, then renamed).  The meta's shard list
    comes from the global positions.  Then a barrier: every process's slabs
    are in place before process 0 writes the av stream and renames the meta
    JSON naming the exact file set into place, the commit point, and prunes
    the files of other steps and any v1 snapshot.  A second barrier keeps
    any process from starting its next save while process 0 prunes.

    Every process of a group calls this (with one process the barriers
    are nothing).  Without a group, a state that lacks shards of its mesh
    (another process's) raises: nobody would write them."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    step = int(step)
    av = _av_prefix(av_vels, step)  # validate before any file is written
    if hasattr(f, "shards"):
        shards, positions = list(f.shards()), f.positions
    else:
        slab = np.asarray(f, dtype=np.float32)
        shards, positions = [(0, 0, slab)], [(0, 0, slab.shape)]
    if dist.process_count() == 1 and len(shards) != len(positions):
        raise RuntimeError(
            f"this process holds {len(shards)} of the mesh's {len(positions)} shards "
            "and is in no process group: the other processes' shards would "
            "never be written")
    rank = dist.process_index()
    for y0, x0, slab in shards:
        name = _shard_filename(step, y0, x0)
        tmp = directory / (name + f".tmp{rank}")
        with open(tmp, "wb") as fp:
            np.savez(fp, f_local=np.asarray(slab, dtype=np.float32))
        tmp.replace(directory / name)
    entries = sorted(
        ({"file": _shard_filename(step, y0, x0), "y0": int(y0), "x0": int(x0),
          "shape": [int(n) for n in shape],
          "mbytes": round(int(np.prod(shape)) * 4 / 1e6, 3)}
         for y0, x0, shape in positions),
        key=lambda e: (e["y0"], e["x0"]))
    meta_path = directory / META_FILENAME
    # Every process's shard files are in place before the meta names them.
    dist.barrier(f"lbm_ckpt_pre_{step}")
    if rank == 0:
        av_tmp = directory / (AV_FILENAME + ".tmp")
        with open(av_tmp, "wb") as fp:
            np.savez(fp, av_vels=av)
        av_tmp.replace(directory / AV_FILENAME)
        meta = {
            "version": 2,
            "params": dataclasses.asdict(params),
            "step": step,
            "mask_digest": _mask_digest(obstacles),
            "shards": entries,
        }
        meta_tmp = directory / (META_FILENAME + ".tmp")
        meta_tmp.write_text(json.dumps(meta, indent=1) + "\n")
        meta_tmp.replace(meta_path)
        _prune_stale(directory, keep={e["file"] for e in entries} | {AV_FILENAME,
                                                                     META_FILENAME})
    dist.barrier(f"lbm_ckpt_post_{step}")
    return meta_path


def _load_sharded(directory: pathlib.Path) -> Checkpoint | None:
    meta_path = directory / META_FILENAME
    if not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text())
    if meta.get("version") != 2:
        raise ValueError(f"unsupported checkpoint version in {meta_path}")
    params = LBMParams(**meta["params"])
    f = np.empty((9, params.ny, params.nx), dtype=np.float32)
    # Coverage is tracked with a mask, not a NaN sentinel in f: a diverged
    # run legitimately holds NaN, and its snapshot must load.
    covered = np.zeros((params.ny, params.nx), dtype=bool)
    for e in meta["shards"]:
        with np.load(directory / e["file"]) as data:
            slab = data["f_local"]
        if list(slab.shape) != e["shape"]:
            raise ValueError(
                f"shard {e['file']}: shape {slab.shape} != meta {e['shape']}"
            )
        ys = slice(e["y0"], e["y0"] + slab.shape[1])
        xs = slice(e["x0"], e["x0"] + slab.shape[2])
        f[:, ys, xs] = slab
        covered[ys, xs] = True
    if not covered.all():
        raise ValueError(
            f"sharded checkpoint in {directory} does not tile the full "
            f"{params.ny}x{params.nx} grid (missing/corrupt shard files)"
        )
    step = int(meta["step"])
    with np.load(directory / AV_FILENAME) as data:
        av = data["av_vels"]
    # The av file is renamed before the meta commit, so a crash between
    # the two leaves a newer av beside the older meta: truncate to the
    # committed step.  A shorter av is corrupt or foreign.
    if av.shape[0] < step:
        raise ValueError(
            f"sharded checkpoint av stream has {av.shape[0]} entries but "
            f"meta commits step {step} ({directory / AV_FILENAME} is "
            "corrupt or from another run)"
        )
    return Checkpoint(
        params=params, step=step, f=f, av_vels=av[:step],
        mask_digest=meta["mask_digest"],
    )


def load(directory: str | pathlib.Path) -> Checkpoint | None:
    """Load the checkpoint in ``directory``, or None if absent.  When both
    layouts are present (one crash window of a save that switched layouts)
    the higher committed step wins, ties to v2."""
    directory = pathlib.Path(directory)
    sharded = _load_sharded(directory)
    single = _load_v1(directory)
    if sharded is not None and single is not None:
        return single if single.step > sharded.step else sharded
    if sharded is not None:
        return sharded
    return single


def _load_v1(directory: pathlib.Path) -> Checkpoint | None:
    path = directory / FILENAME
    if not path.exists():
        return None
    with np.load(path) as data:
        header = json.loads(bytes(data["header"]).decode())
        if header.get("version") != 1:
            raise ValueError(f"unsupported checkpoint version in {path}")
        step = int(header["step"])
        av = data["av_vels"]
        # Every step up to the committed one must have its av entry, as in
        # the v2 loader.
        if av.shape[0] < step:
            raise ValueError(
                f"checkpoint av stream has {av.shape[0]} entries but "
                f"commits step {step} ({path} is corrupt or from "
                "another run)"
            )
        return Checkpoint(
            params=LBMParams(**header["params"]),
            step=step,
            f=data["f"],
            av_vels=av[:step],
            mask_digest=header["mask_digest"],
        )
