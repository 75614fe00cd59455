#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``lbm_tpu_torch``).

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each printed with its seconds:

1. environment: the card (``nvidia-smi`` name and power limit), torch, nvcc;
2. build: ``nvcc`` compiles each ``lbm_tpu_torch/csrc/*.cu`` for sm_90a,
   all at once, and links them into one library, whose persistent
   temporal kernel's, its shard entry's, the persistent x-tiled kernel's,
   its shard entry's, the megakernel's and the cluster and bands
   multi-step kernels' resource usage must be the usage pinned with them
   (LOCAL 0); the 16-bit kernel's is printed (LOCAL 0), the cluster
   kernel's static and dynamic shared memory and the bands kernel's
   blocks, threads and footprint (the C sources' required equal to the
   schedule's); the static SASS instruction counts (``cuobjdump -sass``)
   of the update loop of the grid-barrier, bands and temporal kernels, by
   class (FP32, integer, load/store, conversion, control, other) and the
   calls into the IEEE division and sqrt slow paths;
3. every kernel against its plain torch version on the card, on seeded
   inputs that exercise the body-force gate (1 launch: max |df| <= 1e-6;
   1000 steps: max |df| <= 1e-5 and av rtol <= 1e-4):
   - the one-step kernel at every grid the main path gives it plus two
     with odd block edges, also against the plain version with rho summed
     by ``torch.sum`` (the one the kernel's errors were first recorded
     against);
   - the three multi-step kernels at 64x96, 37x75 and the three small
     canonical grids, with chunk 8 and chunk 200: the grid-barrier kernel
     against plain one-steps; the cluster and bands kernels against their
     plain version (the band algorithm at their bands and threads: f
     bitwise, av within 1e-6 relative), against the grid-barrier kernel
     from the same inputs (f bitwise after one launch and after 1000
     steps, av within 1e-6) and against plain one-steps; each kernel's
     repeated launch from one state the same av bits;
   - the persistent temporal kernel at 1024x1024 with the chosen tiling
     (512 tiles, not a multiple of the grid of 132 blocks) and at small
     grids (fewer tiles than SMs, row ny-2 in a wrapped halo, K > BY), and
     with its f buffers bound as views at an offset of 1 and 2 floats (its
     4- and 8-byte copies), against its plain version and against K plain
     one-steps, f bitwise;
   - the x-tiled (in-place) kernel and the megakernel at three odd grids
     (a wrap kick, K > BY, two tiles) and at three grids of at least three
     tiles a block of their persistent grids (2K > BY at K 3, K 6 > BY,
     one tile column; the megakernel at T 2), after one launch and after
     1000 steps, and at the main path's shapes (8192x8192, 1024x1024) after
     one launch, against their plain versions and against K (T*K) plain
     one-steps: f bitwise, av within 1e-6 relative; at 8192x8192 the
     x-tiled pass bitwise the row temporal kernel's at the same tile and
     K, at 1024x1024 one megakernel launch bitwise T x-tiled launches;
     each kernel's grid (tiles on blocks, tiles left over) printed;
   then times on the card, by CUDA events and as device time from
   torch.profiler: the one-step kernel at 128x128 and 1024x1024; in
   turns (A, B, C, C, B, A), at 128x128 the bound one-step loop, the
   multi-step kernel and a CUDA graph of 200 bound one-step launches, at
   1024x1024 the one-step kernel and the temporal kernel at the chosen
   K and at another K (and their ratio), then a sweep of temporal tiles,
   the three multi-step kernels in turns (A grid barrier, B cluster, C
   bands, C, B, A) at 64x96, 37x75, 128x128, 128x256 and 256x256 with the
   card's cluster admission, its SMs and the route each grid takes
   (required to be the fastest kernel there), the
   synchronisation probe (the grid barrier, the cluster barrier, the
   cluster kernel's ghost-row exchange and the bands kernel's handoff
   through device memory alone) and whether the card admits a cooperative
   launch in clusters,
   at 8192x8192 the x-tiled, temporal and one-step
   kernels, and at 1024x1024 the megakernel against the temporal and
   x-tiled kernels (a grid barrier against a launch boundary);
   the peak device memory of an x-tiled and a ping-pong run at 8192x8192;
   the card's copy bandwidth (2 GiB) and L2-resident copy rate (4 MiB);
4. the main path: the four canonical cases, full length, through the
   port's CLI (``run``) with the default kernel, checked against
   ``tests/goldens/`` at 1%, then 128x128 x 1009 and 1024x1024 x 1001 (step
   counts no chunk or K divides: the one-step branch) against the golden
   prefixes, 1024x1024 x 20000 with ``--kernel mega``, and 128x128 x 40000
   checkpointed, uninterrupted and stopped at 20000 and resumed (the two
   runs' files byte-identical); every kernel's launch count is set to 0
   before each run and read after it, the multi-step cases' against the
   kernel their route takes (``schedule.multi_route``: the bands kernel at
   128x128, 128x256 and 256x256, where the turns of phase 3 favour it),
   and the multi-step kernels the route gives no case launch none; every
   CLI run of the script must parse
   and write through the native I/O (``lbm_tpu_torch._native``, built
   from ``_native/lbmio.c`` with the host's C compiler); final_state.dat
   is checked at 128x128, 128x256 and 256x256.  Then the 1024x1024 run's
   wall time split into its parts (the parse, the library's load, the
   Simulator and its program, the timed loop and the fields payload's copy
   inside it, ``expand_fields``, and both writers in pure Python and
   native, their files byte-identical), and its final_state.dat against
   the fp64 engine (``lbm_tpu_torch.validation.run64``) run on the card:
   the whole run where 20,000 fp64 steps take at most 30 s, else a CLI
   run of 4,000 steps (the checker's 1%, and the largest |du| under 1% of
   the largest |u|);
5. giant grids: ``lbm_tpu_torch.tools.validate_giant``'s ``kernel`` and
   ``fields`` phases at 8192^2 and 16384^2 and its ``ckpt`` fresh and
   resume phases at 8192^2, the resumed run bitwise equal to an
   uninterrupted one; the 8192^2 ``fields`` run's wall time split into
   its set-up, timed loop, ``expand_fields`` and the rest.  An 80 GB H100 holds a ping-pong pair of both
   grids, so the schedule runs them through the row temporal kernel; the
   ``fields`` runs and a second ``ckpt`` pair run with the device budget
   at 0, as on a card that holds the in-place state but not the pair,
   which takes the x-tiled kernel and the carry-resident checkpoint
   driver;
6. reproducibility: the temporal path (1024x1024 x 1000) and the
   multi-step path on its route (128x128 and 256x256 x 1000) twice each,
   bitwise-equal av_vels and f; then the debugging scopes: 128x128 x 200
   inside ``interpret_kernels()`` (no launch, the kernel run's f bits) and
   ``nan_guard()`` around a healthy and a poisoned 1024x1024 x 400 run;
7. sharding, every shard on this card: the shard one-step and temporal
   kernels against their plain versions through whole sharded runs (the
   halo exchange included) at three meshes, 1-D and 2-D halos, one with
   odd tiles, and at the programs of the sharded CLI runs below, after
   one launch and 1000 steps (f bitwise, av within 1e-6 relative);
   sharded runs at 1024x1024 x 400 over 2, 4 and 8 row shards and 2x2 and
   4x2 meshes, both kernels, against the single-device kernel run (f
   bitwise, av within 1e-5); the weak-scaling grid (4096x4096,
   BASELINE.json configs[4]) single-device, over 8 row shards and over
   4x2, in turns, through ``ShardedSimulator.run``, each run's f bitwise
   equal to the single-device run's, with the halo copies' share of
   device time, and each shard kernel against its plain version on those
   tiles; the CLI with ``--shards 4`` (128x128 x 40000) and ``--mesh 2x2``
   (128x256 x 40000) against the goldens and against the single-device
   CLI runs of phase 4 (final_state.dat byte-identical), and a
   checkpointed ``--shards 4`` run stopped and resumed byte-identical.
   Shards on one card share its memory and SMs: no number here is a
   multi-GPU rate;
8. the sharded x-tiled route: the shard x-tiled kernel against its plain
   version through whole sharded runs at three odd slabs over 1, 2 and 4
   rows (one with K > BY, one with row ny-2 on a shard's edge) and at
   three slab pairs of at least three tiles a block of its persistent grid
   (also against plain one-steps of the grid), after one launch and 1000
   steps (f bitwise, av within 1e-6 relative); 8192^2 x
   192 over 2 and 4 row shards and a 2x1 mesh with the device budget at 0,
   so the routing takes it, each run's f bitwise the single-device
   x-tiled run's, one launch on the 8192^2 slabs against the plain
   version, the time per step by CUDA events in turns, the ghost copies'
   share of device time and each run's peak device memory; the CLI with
   ``--shards 4 --temporal-split 32x4x2`` on 1024^2 x 20000 against the
   goldens and phase 4's final_state.dat (byte-identical);
9. the study tools: the three ablation kernels against their plain
   versions (noop and stream bitwise, collide's f bitwise the production
   temporal kernel's), then ``python -m lbm_tpu_torch.tools.ablate_step``
   (the 1024^2 attribution in turns); the three roofline kernels against
   their plain versions (add and fma bitwise, mix within 1e-6 relative),
   then ``python -m lbm_tpu_torch.tools.roofline`` (the issue rates);
10. the tuning path: the 16-bit-storage temporal kernel (a persistent
   pass, its grid printed) against its plain version (the fp32 pass on the
   widened f, rounded to nearest even) in float16 and bfloat16 at six
   shapes (one of at least three tiles a block; 16-, 8- and 4-byte copies
   and plain loads), after one launch and 1000 steps (f within one 16-bit
   step, the values that differ counted; av within 1e-6, then 1e-4,
   relative), and at 1024^2 and 4096^2 in turns with the fp32 kernel from
   one developed state, at 1024^2 f also bound 2 values off its
   allocation (4-byte copies in place of 8-byte ones); ``python -m
   lbm_tpu_torch.tools.fp16_experiment time`` at 1024^2 and 4096^2 (fp32,
   bf16 and fp16 at the chooser's tile, beside their bounds) and ``drift``
   at 256^2 x 80000 and 1024^2 x 20000 in the three types (fp32 within 1%
   of the goldens; the 16-bit runs finite, their drift recorded whatever
   it is); ``lbm autotune`` with ``LBM_TUNING_CACHE`` in a temporary
   directory: a 1024^2 sweep writing ranked, stamped entries, a short
   ``--dry-run`` sweep leaving the file byte for byte, ``--refresh`` re-timing only the
   incumbents, the CLI run of 1024^2 x 20000 taking the cached winner
   (within 1% of the goldens, its program held against its plain
   version), and ``--grid 8192x8192 --steps 16 --repeats 1 --dry-run``
   running the x-tiled timer;
11. the self-contained gate: ``python -m lbm_tpu_torch.tools.check_self``
   on the four cases (av_vels and, where vendored, final_state against
   ``tests/goldens/``) and ``python -m lbm_tpu_torch.tools.bench_all
   --repeats 1 --markdown``, both required to exit 0;
12. a mesh over two processes on this one card: the exchange kernels
   (``lbm_exchange_pack``, ``lbm_exchange_unpack``) bitwise their plain
   versions on every message of the runs below, timed beside them and
   beside ``torch._foreach_copy_``; then ``python -m
   lbm_tpu_torch.tools.multihost_smoke`` (both processes on
   ``LBM_DEVICE=0``, their pieces card to card over CUDA IPC, the
   transport required to read ``ipc``) at 1024^2 x 400 in three runs: the
   shard temporal kernel over 2 processes x 2 row shards, the shard
   one-step kernel over a 2x2 mesh, and the shard x-tiled kernel over 2 x
   1 rows (``--temporal-split 32x4x2``); and ``BASELINE.json``
   ``configs[4]``'s 4096^2 x 400 over 2 processes x 4 row shards (the
   shard temporal kernel, the default split).  In each, every process's f
   is bitwise the single-device run's and the same mesh's single-process
   run's, av bitwise the single-process run's, the meta committed over
   both processes' shard files, a half run resumed on the other mesh
   shape bitwise the whole run, and two launches of the kernel in the
   two-process run bitwise their plain version; each run's launches
   (shard kernel, pack, unpack) counted in its workers' checkpointed
   runs.  The µs a step of the two-process run beside the same mesh in
   one process, and the exchange alone over CUDA IPC and over gloo in
   turns, are printed beside the card, with whether an MPS daemon runs.
   Two processes time-slice one card: no number here is a multi-GPU rate.

Phase 2 also prints ``cuobjdump --dump-resource-usage`` of the
persistent temporal, x-tiled and mega kernels and the cluster and bands
multi-step kernels and requires it to equal the pinned usage
(RESOURCE_KERNELS).  Every kernel of the kernels line carries
``bound_ms`` (bytes or operations at the published rates) and
``bound_ms_issue`` (its fp32 operations at the measured mix rate).

Any failure raises (non-zero exit, no result line).  On success the line
before the last is the kernels' JSON record and the last line is
``{"ok": true, "device": {...}}``.  Needs no JAX and no network; takes
six to eleven minutes on an H100, the build included (the host-bound
plain versions of phases 3, 7 and 8 vary most).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDENS = ROOT / "tests" / "goldens"
WORK = ROOT / "build" / "chip_smoke"

# Grids with partial blocks in x and y; the canonical grids are added to
# them in phase 3, so the kernel is checked at every shape the main path
# gives it.
ODD_SHAPES = ((64, 96), (37, 75))  # (ny, nx)
TIMED_SHAPES = ((128, 128), (1024, 1024))  # (ny, nx)
CASES = ("128x128", "128x256", "256x256", "1024x1024")
SMALL_CASES = CASES[:3]
FINAL_STATE_GOLDENS = ("128x128", "128x256", "256x256")
# 1024^2's final_state.dat against the fp64 engine (lbm_tpu_torch.validation)
# run on the card in the same call: the canonical run's own file where the
# fp64 engine's 20,000 steps take at most FP64_FULL_LIMIT_S (by the time of
# FP64_PROBE_STEPS steps), else a CLI run of FP64_CUT_STEPS steps against
# as many fp64 steps.  Beside the checker's 1%: the largest |du_x|, |du_y|
# and |d|u|| over all cells under FP64_DU_LIMIT of the fp64 run's largest
# |u| (the fp16 fields payload's quantum is 2^-11 of a value).
FP64_PROBE_STEPS, FP64_FULL_LIMIT_S, FP64_CUT_STEPS, FP64_DU_LIMIT = 200, 30.0, 4000, 0.01
# The native I/O calls of one CLI run: every run on the card must parse and
# write through lbm_tpu_torch._native, never the pure-Python fallback.
NATIVE_PER_RUN = {"write_final_state": 1, "write_av_vels": 1, "parse_obstacles": 1}
# The giant grid whose validate_giant fields run is split into its parts.
GIANT_SPLIT = 8192
# Step counts that no chunk or K divides: the chooser's one-step branch.
ONE_STEP_RUNS = (("128x128", 1009), ("1024x1024", 1001))
MULTI_CHUNKS = (8, 200)
# The kernel of each route of the multi-step program.
LAUNCH_NAMES = {"grid": "lbm_multi_step", "cluster": "lbm_multi_cluster_step",
                "bands": "lbm_multi_bands_step"}
# The cluster and bands multi-step kernels' av against their plain version
# and against the grid-barrier kernel's, relative (their f is bitwise both).
TOL_AV_CLUSTER = 1e-6
# (ny, nx, by, bx, K, offset) besides the chosen 1024x1024 tiling, the f
# buffers bound as views `offset` floats into their allocations: 64x96
# holds row ny-2 in the bottom tile row's wrapped south halo and the top
# row's interior, in 6 tiles (fewer than SMs); 12x20 has K > BY, so ny-2
# also lies in other tiles' north halos (and K 6 takes 8-byte copies);
# offsets 1 and 2 narrow the copies to 4 and 8 bytes, the second at
# 1024x1024 in 32x32 tiles (1024 tiles, not a multiple of the grid).  The
# persistent kernel equals its plain version to the bit.
TEMPORAL_SMALL = ((64, 96, 16, 32, 4, 0), (12, 20, 4, 4, 6, 0), (64, 96, 16, 32, 4, 1),
                  (1024, 1024, 32, 32, 4, 2))
TOL_F_1, TOL_F_N, TOL_AV_N, N_STEPS = 1e-6, 1e-5, 1e-4, 1000
# (ny, nx, by, bx, K, T) of the in-place kernels' odd shapes: 64x96 holds
# row ny-2 in the top tile row and, wrapped, in the bottom row's south halo
# (the wrap kick); 12x20 has K > BY (halos two tiles deep); 16x24 in 8x24
# tiles is a two-tile grid.  The in-place kernels equal their plain
# versions in f to the bit, av within TOL_AV_INPLACE relative.
INPLACE_SMALL = ((64, 96, 16, 32, 4, 3), (12, 20, 4, 4, 6, 5), (16, 24, 8, 24, 3, 2))
TOL_AV_INPLACE = 1e-6
# (ny, nx, BY, BX, K, T) of the x-tiled kernel and the megakernel at grids
# of at least three tiles for every block of their persistent grids (at
# most 4 blocks of 512 threads an SM, 132 SMs: 528 blocks, 1,584 tiles), so
# that their blocks copy the next tile's window while the current one
# steps: 2K > BY at K 3 (4-byte copies; the megakernel's by `__ldcg`), K 6
# > BY (8-byte copies, halos two tile rows deep), and one tile column
# (tiles_x 1, every x halo its own tile's).  Phase 3 requires the three
# tiles a block of each grid.
INPLACE_PREFETCH = ((256, 448, 4, 16, 3, 2), (256, 448, 4, 16, 6, 2),
                    (3200, 32, 2, 32, 3, 2))
# lbm_tpu's validated giant sizes, and validate_giant's step count.
GIANT_SIZES = (8192, 16384)
GIANT_STEPS = 192
# The checkpointed CLI run: 128x128 x 40000, stopped at CKPT_STOP and resumed.
CKPT_CASE, CKPT_STOP = "128x128", 20000
GRAPH_STEPS = 200  # one-step launches captured in the CUDA graph
BARRIER_STEPS = 5000  # steps a launch of the synchronisation probe
# Temporal tilings (by, bx) swept at 1024x1024 for each K of the chooser:
# the measurement behind ops/schedule.py's TEMPORAL_TILES order.
SWEEP_TILES = ((32, 32), (16, 32), (32, 64), (64, 32), (16, 64), (16, 16), (8, 32))
# (ny, nx, py, px, BY, K) of the shard kernels against their plain versions
# (px None: a 1-D mesh of py row shards): 64x96 over 4 rows (16x96 tiles,
# row ny-2 in the last shard); 74x150 over 2x2 (odd 37x75 tiles, 1x75
# temporal tiles, K > BY); 48x128 over 4x2 (12x64 tiles, K 6 > BY 4).
SHARD_SHAPES = ((64, 96, 4, None, 16, 4), (74, 150, 2, 2, 1, 3), (48, 128, 4, 2, 4, 6))
# (case, py, px) of the sharded CLI runs: their programs are held against
# their plain versions too (128x128 over 4 rows takes the temporal kernel on
# 32x128 tiles, 128x256 over 2x2 the one-step kernel on 64x128 tiles).
SHARD_CLI = (("128x128", 4, None), ("128x256", 2, 2))
# Sharded f against the single-device kernel run: 1024^2 x 400 steps over
# these meshes, both kernels; av within SHARD_AV_RTOL (the shards' sums
# add in another order).
SHARD_MESHES = ((2, None), (4, None), (8, None), (2, 2), (4, 2))
SHARD_EQ_STEPS, SHARD_AV_RTOL = 400, 1e-5
# The weak-scaling grid of BASELINE.json configs[4] on one card, and the
# steps of each timed run.
SHARD_BIG, SHARD_BIG_STEPS = 4096, 2000
# (ny, nx, py, BY, K, PX) of the shard x-tiled kernel against its plain
# version: 64x96 as one shard (its ghost rows its own edges), 24x40 over 2
# rows (K 5 > BY 2: the ghost rows span several of the neighbour's tile
# rows), 8x48 over 4 rows (row ny-2 is the last shard's first row).
XT_SHARD_SHAPES = ((64, 96, 1, 16, 4, 2), (24, 40, 2, 2, 5, 2), (8, 48, 4, 2, 2, 3))
# (ny, nx, py, BY, BX, K) of the shard x-tiled kernel over 2 rows at slabs
# of at least three tiles a block of its persistent grid, as
# INPLACE_PREFETCH (BX given, so one tile column is reachable).
XT_SHARD_PREFETCH = ((512, 448, 2, 4, 16, 3), (512, 448, 2, 4, 16, 6),
                     (6400, 32, 2, 2, 32, 3))
# At least this many tiles a block of the persistent grid at the prefetch
# shapes.
PREFETCH_TILES_A_BLOCK = 3
# Phase 8c's CLI run: (case, row shards, temporal split).
XT_SHARD_CLI = ("1024x1024", 4, (32, 4, 2))
# (ny, nx, BY, BX, K) of the ablation kernels against their plain versions:
# the tool's 1024^2 tile, and 64x96 (row ny-2 in a wrapped halo).
ABLATE_SHAPES = ((1024, 1024, 32, 64, 4), (64, 96, 16, 32, 4))
ROOFLINE_MIX_RTOL = 1e-6
# The b of the roofline kernels' check: lbm_tpu's 1e-30 leaves x + b == x
# for the check's x of order 1, so the check passes a b that moves x.
ROOFLINE_CHECK_B = 1e-3
# The resource usage (cuobjdump --dump-resource-usage) of the persistent
# temporal kernel and its shard entry, of the x-tiled kernel and its shard
# entry, and of the megakernel, each as the tree that made it persistent
# built it (no local memory, the |u| slots' 4 KiB of static shared memory),
# on an NVIDIA H100 80GB HBM3 (700 W): adding an entry beside a kernel must
# leave its code as it was.  The cluster
# multi-step kernel's as its build on that card gave it: 1,024 threads a
# block leave 64 registers a thread, and LOCAL 0 says nothing spills
# (SHARED: its 128 B of warp sums, 32 B of mbarriers and the 1 KiB the
# card reserves a block).  The bands kernel's likewise: at most 512
# threads a block leave 128 registers, and STACK 0 says that its poll of
# up to ten words a thread does not spill (SHARED: its 128 B of warp sums
# and the 1 KiB reserved).
RESOURCE_KERNELS = {
    "lbm_temporal_kernel": "REG:52 STACK:0 SHARED:5120 LOCAL:0 CONSTANT[0]:720 "
                           "TEXTURE:0 SURFACE:0 SAMPLER:0",
    "lbm_shard_temporal_kernel": "REG:52 STACK:0 SHARED:5120 LOCAL:0 CONSTANT[0]:720 "
                                 "TEXTURE:0 SURFACE:0 SAMPLER:0",
    "lbm_xt_kernel": "REG:64 STACK:0 SHARED:5120 LOCAL:0 CONSTANT[0]:744 TEXTURE:0 "
                     "SURFACE:0 SAMPLER:0",
    "lbm_shard_xt_kernel": "REG:62 STACK:0 SHARED:5120 LOCAL:0 CONSTANT[0]:752 "
                           "TEXTURE:0 SURFACE:0 SAMPLER:0",
    "lbm_mega_kernel": "REG:64 STACK:0 SHARED:5120 LOCAL:0 CONSTANT[0]:752 TEXTURE:0 "
                       "SURFACE:0 SAMPLER:0",
    "lbm_multi_cluster_kernel": "REG:64 STACK:0 SHARED:1184 LOCAL:0 CONSTANT[0]:668 "
                                "TEXTURE:0 SURFACE:0 SAMPLER:0",
    "lbm_multi_bands_kernel": "REG:128 STACK:0 SHARED:1152 LOCAL:0 CONSTANT[0]:680 "
                              "TEXTURE:0 SURFACE:0 SAMPLER:0",
}
# The kernels whose cell-update loop phase 2 counts in the SASS
# (``cuobjdump -sass``): the innermost loop that holds an update (its |u|'s
# MUFU.RSQ) is taken as the update's loop body.  Each instruction is
# classed by its opcode (the uniform datapath's ``U`` ops with the integer
# ones); a call by the slow path it enters, named by its target or, where
# the target has no name, by its body's MUFU.RSQ (the IEEE sqrt) or
# MUFU.RCP (the IEEE division).
SASS_KERNELS = ("lbm_multi_kernel", "lbm_multi_bands_kernel", "lbm_temporal_kernel")
SASS_CLASSES = {
    "fp32": {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I", "FSETP", "FSET",
             "FSEL", "FMNMX", "FCHK", "MUFU", "FRND", "FSWZADD", "FCMP"},
    "integer": {"IMAD", "IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL",
                "SHR", "ISETP", "LEA", "IMNMX", "IABS", "SEL", "PRMT", "ISCADD", "IMUL",
                "POPC", "FLO", "BREV", "BMSK", "SGXT", "ISET", "IMUL32I"},
    "load_store": {"LDG", "STG", "LDS", "STS", "LD", "ST", "LDL", "STL", "ATOM", "ATOMS",
                   "ATOMG", "RED", "LDGSTS", "LDSM", "STSM", "LDGDEPBAR"},
    "convert": {"F2F", "F2I", "I2F", "F2FP", "I2FP", "F2IP"},
    "control": {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY", "BSYNC", "BAR",
                "WARPSYNC", "YIELD", "BREAK", "NANOSLEEP", "BPT", "KILL"},
}
SHARD_PROFILE_STEPS = 200
# The 16-bit kernel's two instantiations, whose resource usage phase 2
# prints and requires without local memory (a spill would show as LOCAL
# above 0): label -> mangled-name part.
PRINTED_KERNELS = {"lbm_temporal16_kernel<__half>": "lbm_temporal16_kernelI6__half",
                   "lbm_temporal16_kernel<__nv_bfloat16>":
                       "lbm_temporal16_kernelI13__nv_bfloat16"}
# Phase 10, the tuning path.  (ny, nx, BY, BX, K) of the 16-bit kernel
# against its plain version: 64x96 holds row ny-2 in the bottom tile row's
# wrapped south halo; 48x80 in 8x16 tiles at K 2 (4-byte copies); 1024^2
# at the chooser's tile (8-byte copies); 512x448 in 8x16 tiles at K 2,
# 1,792 tiles, at least three a block of its persistent grid; 48x90 in
# 8x18 tiles at K 3 (plain loads: the window rows start on odd columns);
# 128^2 in 16x32 tiles at K 8 (16-byte copies).  av within TOL_AV16_1
# relative after one launch.
TEMPORAL16_SHAPES = ((64, 96, 16, 32, 4), (48, 80, 8, 16, 2), (1024, 1024, 32, 64, 4),
                     (512, 448, 8, 16, 2), (48, 90, 8, 18, 3), (128, 128, 16, 32, 8))
# The 16-bit f bound this many values into its allocation in phase 10's
# turns: its copies narrow from 8 to 4 bytes.
OFFSET16 = 2
# (n, steps a turn, steps of flow before the turns) of phase 10's turns of
# the fp32 and 16-bit kernels at n x n, each turn from the developed state.
TURNS16 = ((1024, 4800, 4000), (4096, 480, 1000))
TOL_AV16_1 = 1e-6
# fp16_experiment's time runs (grid, steps; None: the tool's 4800) and its
# drift cases, full length.
TIME16_RUNS = (("1024x1024", None), ("4096x4096", 480))
DRIFT_CASES = ("256x256", "1024x1024")

# The card's published rates (NVIDIA's H100 SXM datasheet, at
# 700 W): device memory and fp32 outside the tensor cores.  A cell update
# does 104 fp32 operations (lbm_tpu's pinned count, tests/test_perf_model.py)
# and must move 73 B once per pass (9 fp32 + the mask byte in, 9 fp32 out).
# Phase 12: multihost_smoke at MULTIHOST_STEPS steps over two
# processes on the card, (grid, its arguments, the shard kernel its main
# path launches, shards of the mesh); the last is BASELINE.json
# configs[4]'s weak-scaling grid.
MULTIHOST_STEPS = 400
MULTIHOST_RUNS = (("1024x1024", ["--kernel", "temporal"], "lbm_shard_temporal_step", 4),
                  ("1024x1024", ["--mesh", "2x2", "--kernel", "fused"], "lbm_shard_step", 4),
                  ("1024x1024", ["--kernel", "temporal", "--temporal-split", "32x4x2",
                                 "--local-devices", "1"], "lbm_shard_temporal_xt_step", 2),
                  ("4096x4096", ["--kernel", "temporal", "--local-devices", "4"],
                   "lbm_shard_temporal_step", 8))
EXCHANGE_KERNELS = ("lbm_exchange_pack", "lbm_exchange_unpack")
EXCHANGE_TIMED = 200  # launches a timed turn of the exchange kernels

MEM_BYTES_PER_S = 3.35e12
# The fp32 instruction peak: every kernel is built with -fmad=false
# (ops/_build.py), so each counted operation is one FP32 instruction, and
# the published 67 TFLOP/s counts an FMA as two: 132 SMs x 128 lanes x
# 1.98 GHz is 33.5e12 instructions a second.
FP32_OPS_PER_S = 67e12 / 2
OPS_PER_UPDATE = 104


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name: str):
    tic = time.perf_counter()
    yield
    print(f"[phase] {name}: {time.perf_counter() - tic:.3f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    require(bool(out), "nvidia-smi printed no card")
    return out.splitlines()[0]


def phase_env(torch) -> str:
    from lbm_tpu_torch.ops import _build

    card = card_line()
    print(card)
    nvcc = _build.find_nvcc()
    require(nvcc is not None, "nvcc not found")
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__} "
          f"(CUDA {torch.version.cuda}), nvcc: {nvcc_version}, "
          f"devices: {torch.cuda.device_count()}")
    return card


def phase_build() -> dict:
    from lbm_tpu_torch.ops import _build

    path = _build.library_path()
    tic = time.perf_counter()
    _build.load_library()
    print(f"built {path.relative_to(ROOT)} in {time.perf_counter() - tic:.3f} s")
    log = path.with_name(path.name + ".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "Compiling entry" in line):
                print(f"  {line.strip()}")
    found = _kernel_resources(path)
    for name, want in RESOURCE_KERNELS.items():
        print(f"  cuobjdump {name}: {found.get(name)} (pinned: {want})")
        require(found.get(name) == want,
                f"{name}'s resource usage {found.get(name)} differs from its pin {want}")
    for label in PRINTED_KERNELS:
        require(label in found, f"cuobjdump lists no {label}")
        print(f"  cuobjdump {label}: {found[label]}")
        require(" LOCAL:0 " in f" {found[label]} ", f"{label} uses local memory")
    _print_cluster_smem(found["lbm_multi_cluster_kernel"])
    _print_bands_plan(found["lbm_multi_bands_kernel"])
    found["sass"] = _sass_counts(path)
    return found


def _print_bands_plan(usage: str) -> None:
    """The bands kernel's static shared memory (cuobjdump), and its blocks,
    threads and dynamic shared memory at every grid phase 3 gives it, the C
    source's and the schedule's required equal."""
    import torch

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops import _build, schedule

    lib = _build.load_library()
    sms = schedule.bands_admission(torch.device("cuda", 0))
    plans = {}
    for ny, nx in ODD_SHAPES + tuple(CANONICAL_PARAMS[c].shape for c in SMALL_CASES):
        g, _, threads, smem = schedule.bands_plan(ny, nx, sms)
        got = (lib.lbm_multi_bands_threads(ny, nx, g),
               lib.lbm_multi_bands_smem_bytes(ny, nx, g))
        require(got == (threads, smem), f"{nx}x{ny}: the bands kernel's threads and "
                                        f"footprint {got} are not the schedule's "
                                        f"{(threads, smem)}")
        plans[f"{nx}x{ny}"] = f"{g} blocks of {threads} threads, {smem} B"
    static = re.search(r"SHARED:(\d+)", usage).group(1)
    print(f"  lbm_multi_bands_kernel on {sms} SMs: static shared memory {static} B; "
          + ", ".join(f"{grid} {plan}" for grid, plan in plans.items())
          + f" (dynamic, each block asking for at least half an SM's); budget "
          f"{schedule.BANDS_SMEM_BUDGET} B")


def _sass_class(op: str) -> str:
    base = op.split(".")[0]
    for name, ops in SASS_CLASSES.items():
        if base in ops or (base.startswith("U") and base[1:] in ops and name == "integer"):
            return name
    return "other"


def _parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` output -> {function: ([(address, instruction)],
    {label: address})}."""
    funcs, current, pending = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current, pending = m.group(1), []
            funcs[current] = ([], {})
            continue
        if current is None:
            continue
        lm = re.match(r"\s*([.$\w@]+):\s*$", line)
        if lm:
            pending.append(lm.group(1))
            continue
        im = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if im:
            addr = int(im.group(1), 16)
            for label in pending:
                funcs[current][1][label] = addr
            pending = []
            funcs[current][0].append((addr, im.group(2)))
    return funcs


def _opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P[T0-9]+\s+", "", ins).split()[0]


def _target(ins: str, labels: dict):
    m = re.search(r"`\(([^)]+)\)", ins)
    if m:
        return m.group(1), labels.get(m.group(1))
    m = re.search(r"\b0x([0-9a-f]+)\b", ins)
    return (None, int(m.group(1), 16)) if m else (None, None)


def _callee(ins: list, labels: dict, call: str) -> str:
    """``"div"``, ``"sqrt"`` or ``"other"``: the slow path a CALL enters,
    by its target's name, else by the reciprocal or reciprocal square root
    its body (up to its RET) starts from."""
    name, addr = _target(call, labels)
    if name and ("div" in name.lower() or "sqrt" in name.lower()):
        return "div" if "div" in name.lower() else "sqrt"
    ops = []
    for a, x in ins:
        if addr is not None and a >= addr:
            ops.append(_opcode(x))
            if ops[-1].startswith("RET"):
                break
    return ("sqrt" if "MUFU.RSQ" in ops else "div" if "MUFU.RCP" in ops else "other")


def _tally(body: list, ins: list, labels: dict) -> dict:
    """Instructions of ``body`` (of the function ``ins``) by class, and its
    calls by slow path."""
    out = dict.fromkeys(list(SASS_CLASSES) + ["other"], 0)
    calls = {"div": 0, "sqrt": 0, "other": 0}
    for _, x in body:
        op = _opcode(x)
        out[_sass_class(op)] += 1
        if op.startswith("CALL"):
            calls[_callee(ins, labels, x)] += 1
    out["total"] = len(body)
    out["calls"] = calls
    return out


def _sass_counts(path: pathlib.Path) -> dict:
    """Static SASS instruction counts of each of SASS_KERNELS: its
    cell-update loop body (the innermost loop holding the most FP32
    instructions) and the whole function, by class, printed."""
    from lbm_tpu_torch.ops import _build

    cuobjdump = str(pathlib.Path(_build.find_nvcc()).with_name("cuobjdump"))
    usage = subprocess.run([cuobjdump, "--dump-resource-usage", str(path)],
                           capture_output=True, text=True, check=True, timeout=120).stdout
    names = []
    for name in SASS_KERNELS:
        m = re.search(rf"Function (\S*\d{name}E\S*?):", usage)
        require(m is not None, f"cuobjdump lists no {name}")
        names.append(m.group(1))
    text = subprocess.run([cuobjdump, "-sass", "-fun", ",".join(names), str(path)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    funcs = _parse_sass(text)
    out = {}
    for name in SASS_KERNELS:
        key = next((k for k in funcs if re.search(rf"\d{name}E", k)), None)
        require(key is not None, f"cuobjdump -sass lists no {name}")
        ins, labels = funcs[key]
        loops = []
        for addr, text_ in ins:
            if _opcode(text_).split(".")[0] != "BRA":
                continue
            target = _target(text_, labels)[1]
            if target is not None and target <= addr:
                body = [x for x in ins if target <= x[0] <= addr]
                if any(_opcode(x) == "MUFU.RSQ" for _, x in body):
                    loops.append((len(body), target, addr, body))
        rec = {"function": _tally(ins, ins, labels), "update_loops": len(loops)}
        if loops:
            _, start, end, body = min(loops, key=lambda t: t[0])
            rec["update_loop"] = dict(_tally(body, ins, labels), start=hex(start),
                                      end=hex(end))
        out[name] = rec
        loop = rec.get("update_loop")
        print(f"  SASS {name}: update loop "
              + (f"[{loop['start']}, {loop['end']}] {loop['total']} instructions: "
                 + ", ".join(f"{c} {loop[c]}" for c in list(SASS_CLASSES) + ["other"])
                 + f"; calls {loop['calls']}" if loop else "not found")
              + f"; whole function {rec['function']['total']} instructions, "
              + ", ".join(f"{c} {rec['function'][c]}" for c in list(SASS_CLASSES) + ["other"])
              + f", calls {rec['function']['calls']}; {len(loops)} loops hold an update")
    return out


def _print_cluster_smem(usage: str) -> None:
    """The cluster kernel's static shared memory (cuobjdump) and its
    dynamic shared memory at every grid phase 3 gives it, the C source's
    and the schedule's footprints required equal."""
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops import _build, schedule

    lib = _build.load_library()
    dyn = {}
    for ny, nx in ODD_SHAPES + tuple(CANONICAL_PARAMS[c].shape for c in SMALL_CASES):
        c = min(schedule.CLUSTER_MAX, ny)
        dyn[f"{nx}x{ny}"] = lib.lbm_multi_cluster_smem_bytes(ny, nx, c)
        require(dyn[f"{nx}x{ny}"] == schedule.cluster_smem_bytes(ny, nx, c),
                f"{nx}x{ny}: the cluster kernel's footprint {dyn[f'{nx}x{ny}']} B is not "
                f"the schedule's {schedule.cluster_smem_bytes(ny, nx, c)} B")
    static = re.search(r"SHARED:(\d+)", usage).group(1)
    print(f"  lbm_multi_cluster_kernel shared memory: static {static} B; dynamic a "
          "block (16 blocks) "
          + ", ".join(f"{g} {b} B" for g, b in dyn.items())
          + f"; budget {schedule.CLUSTER_SMEM_BUDGET} B")


def _setup(ny, nx, seed, dev, torch):
    """Seeded gate-case inputs on the card: (params, obstacles, fcinv, f0)."""
    import numpy as np

    from lbm_tpu_torch.geometry import free_cells_of
    from lbm_tpu_torch.testing import gate_case

    params, obstacles, f0_np = gate_case(ny, nx, seed)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    return params, obstacles, fcinv, torch.from_numpy(f0_np).to(dev)


def _run_kernel(prog, f0, launches, torch, offset: int = 0):
    """``launches`` kernel launches from ``f0``, bound as the main path
    binds them (with ``offset``, each buffer a view that many elements
    into its allocation): (f, av[launches * chunk])."""
    if offset:
        bufs = [torch.empty(f0.numel() + offset, dtype=f0.dtype, device=f0.device)
                [offset:].view(f0.shape) for _ in range(prog.n_buffers)]
        bufs[0].copy_(f0)
    else:
        bufs = [f0.clone()] + [torch.empty_like(f0) for _ in range(prog.n_buffers - 1)]
    av = torch.empty(launches * prog.chunk, dtype=torch.float32, device=f0.device)
    launch = prog.bind(*bufs, av)
    for i in range(launches):
        launch(i)
    return bufs[prog.final_index(launches)], av


def _bound_loop(prog, f0, torch, cap: int = 64, offset: int = 0, reset: bool = False):
    """``run(steps)`` that advances one bound state of ``prog`` by whole
    launches, cycling over ``cap`` (even) av slots: times the launches
    alone, with no copy of f0 or fill of bands per call.  With ``offset``,
    each buffer is a view that many elements into its allocation; with
    ``reset``, each timed call starts again from f0 (``run.reset``, which
    :func:`_ms_per_step` calls before its timed window, copies f0 back, so
    that every turn does the same work and the copy is not timed)."""
    if offset:
        bufs = [torch.empty(f0.numel() + offset, dtype=f0.dtype, device=f0.device)
                [offset:].view(f0.shape) for _ in range(prog.n_buffers)]
        bufs[0].copy_(f0)
    else:
        bufs = [f0.clone()] + [torch.empty_like(f0) for _ in range(prog.n_buffers - 1)]
    av = torch.empty(cap * prog.chunk, dtype=torch.float32, device=f0.device)
    launch = prog.bind(*bufs, av)
    state = {"i": 0}

    def run(steps):
        for _ in range(steps // prog.chunk):
            launch(state["i"] % cap)
            state["i"] += 1

    def restart():
        bufs[0].copy_(f0)
        state["i"] = 0

    if reset:
        run.reset = restart
    return run


def _run_checked(step, f0, steps, torch):
    """As :func:`_run_kernel` for the one-step kernel, but each launch
    through ``step(...)``, which checks its tensors on every call: the cost
    that binding removes."""
    a, b = f0.clone(), torch.empty_like(f0)
    av = torch.empty(steps, dtype=torch.float32, device=f0.device)
    for t in range(steps):
        step(a, b, av, t)
        a, b = b, a
    return a, av


def _run_plain(prog, f0, launches, torch):
    """The plain version of ``launches`` launches of ``prog``."""
    f, avs = f0, []
    for _ in range(launches):
        f, a = prog.plain_launch(f)
        avs.append(a)
    return f, torch.cat(avs)


def _run_plain_steps(prog, f0, steps, torch):
    """``steps`` plain one-steps (``prog.plain``)."""
    f, avs = f0, []
    for _ in range(steps):
        f, a = prog.plain(f)
        avs.append(a)
    return f, torch.stack(avs)


@contextlib.contextmanager
def _torch_sum_plain(torch):
    """The plain step with rho summed by ``torch.sum`` over the 9 planes.
    The plain step sums left to right, as the kernels do; the one-step
    kernel's errors were first recorded against this older form, so its
    errors against it show that the kernel's results did not change."""
    from lbm_tpu_torch.ops import reference

    orig = reference.macroscopic

    def macroscopic(tmp):
        rho = torch.sum(tmp, dim=0)
        mx = tmp[1] + tmp[5] + tmp[8] - tmp[3] - tmp[6] - tmp[7]
        my = tmp[2] + tmp[5] + tmp[6] - tmp[4] - tmp[7] - tmp[8]
        return rho, 1.0 / rho, mx, my

    reference.macroscopic = macroscopic
    try:
        yield
    finally:
        reference.macroscopic = orig


def _errs(k, kav, p, pav):
    """(max |df|, max relative av difference)."""
    return ((k - p).abs().max().item(),
            ((kav - pav).abs() / pav.abs()).max().item())


def _check(label, err1, errn, avn, k):
    require(err1 <= TOL_F_1, f"{label}: 1-launch max|df| {err1} > {TOL_F_1}")
    require(errn <= TOL_F_N, f"{label}: {N_STEPS}-step max|df| {errn} > {TOL_F_N}")
    require(avn <= TOL_AV_N, f"{label}: {N_STEPS}-step av rel {avn} > {TOL_AV_N}")
    require(bool(k.isfinite().all()), f"{label}: non-finite f")


def _ms_per_step(run, steps, torch, warm=None) -> float:
    run(warm if warm is not None else 10)  # warm-up
    if hasattr(run, "reset"):
        run.reset()  # before the timed window, so the copy is not timed
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(steps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def _device_profile(run, steps, torch, warm=None, calls=None) -> dict:
    """Device busy time per step from a torch.profiler (CUPTI) window over
    ``steps`` steps, beside the window's wall time per step; ``None`` where
    the profiler recorded no device activity.  ``calls`` is the number of
    times each kernel of ``run`` launches in the window, where that is
    known: each kernel's time is then its mean per recorded call times
    ``calls``, since the profiler may drop records of multi-millisecond
    kernels (seen at 8192^2: 6 of 10 recorded; the counts are kept)."""
    from torch.profiler import ProfilerActivity, profile

    run(warm if warm is not None else 10)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    kernels = {e.key: (e.self_device_time_total / e.count * calls if calls
                       else e.self_device_time_total) / steps for e in events}
    busy = sum(kernels.values())
    wall_us = wall * 1e6 / steps
    return {
        "device_us": busy or None,
        "wall_us": wall_us,
        "busy_share": busy / wall_us if busy else None,
        "by_kernel_us": {k[:60]: v for k, v in kernels.items()} if busy else None,
        "recorded_calls": {e.key[:60]: e.count for e in events},
        "expected_calls": calls,
    }


def _turns(runs: dict, order: str, steps: dict, torch, warm: dict) -> dict:
    """Time each named run in the given order of turns (e.g. "ABCCBA");
    returns {name: [ms per step, ...]} in the order taken."""
    out = {name: [] for name in runs}
    for name in order:
        out[name].append(_ms_per_step(runs[name], steps[name], torch, warm[name]))
    return out


def phase_copy_bandwidth(torch, card: str) -> float:
    """Device-to-device copy bandwidth (bytes read + written per second)
    of a 2 GiB buffer: the practical ceiling a bandwidth-bound step is
    held against."""
    n = 2**29  # fp32 elements: 2 GiB, far beyond the 50 MB L2
    src = torch.ones(n, dtype=torch.float32, device="cuda:0")
    dst = torch.empty_like(src)
    dst.copy_(src)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 20
    start.record()
    for _ in range(reps):
        dst.copy_(src)
    end.record()
    torch.cuda.synchronize()
    gbs = 2 * 4 * n * reps / (start.elapsed_time(end) * 1e-3) / 1e9
    print(f"device copy bandwidth: {gbs:.1f} GB/s (read + write, 2 GiB buffer) "
          f"| {card}")
    del src, dst
    torch.cuda.empty_cache()
    return gbs


def phase_l2_copy(torch, card: str) -> float:
    """Copy rate (bytes read + written per second of device time) of a
    4 MiB buffer, which stays in the 50 MB L2: the yardstick of the
    multi-step kernel, whose two f buffers stay there too.  A 4 MiB copy
    takes less time on the card than its launch takes on the host, so the
    rate comes from the profiler's device time, not from CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    n = 2**20  # fp32 elements: 4 MiB
    src = torch.ones(n, dtype=torch.float32, device="cuda:0")
    dst = torch.empty_like(src)
    for _ in range(10):
        dst.copy_(src)
    torch.cuda.synchronize()
    reps = 500
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            dst.copy_(src)
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    require(device_us > 0, "the profiler recorded no device time for the L2 copies")
    gbs = 2 * 4 * n * reps / (device_us * 1e-6) / 1e9
    print(f"L2-resident copy rate: {gbs:.1f} GB/s (read + write, 4 MiB buffer, "
          f"{device_us / reps:.3f} us of device time a copy) | {card}")
    return gbs


def phase_fused(torch, card: str) -> dict:
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.utils.profiling import BYTES_PER_CELL

    dev = torch.device("cuda", 0)
    rec = {"max_abs_err": 0.0, "max_abs_err_1000": 0.0, "av_rtol_1000": 0.0,
           "by_shape": {}, "timing": {}}
    shapes = ODD_SHAPES + tuple(CANONICAL_PARAMS[c].shape for c in CASES)
    # Labelled nx x ny, as the canonical cases are.  Seeds follow the
    # position in this list; new grids go in the later phases, so these
    # keep theirs.
    for seed, (ny, nx) in enumerate(shapes):
        params, obstacles, fcinv, f0 = _setup(ny, nx, seed, dev, torch)
        step = fused.FusedStep(params, obstacles, fcinv, dev)

        before = fused.LAUNCHES["lbm_fused_step"]
        k1, kav1 = _run_kernel(step, f0, 1, torch)
        kn, kavn = _run_kernel(step, f0, N_STEPS, torch)
        torch.cuda.synchronize()
        launched = fused.LAUNCHES["lbm_fused_step"] - before
        p1, pav1 = _run_plain(step, f0, 1, torch)
        pn, pavn = _run_plain(step, f0, N_STEPS, torch)
        with _torch_sum_plain(torch):
            q1, qav1 = _run_plain(step, f0, 1, torch)
            qn, qavn = _run_plain(step, f0, N_STEPS, torch)
        err1, av1 = _errs(k1, kav1, p1, pav1)
        errn, avn = _errs(kn, kavn, pn, pavn)
        old1, _ = _errs(k1, kav1, q1, qav1)
        oldn, oldavn = _errs(kn, kavn, qn, qavn)
        print(f"one-step {nx}x{ny}: 1 step max|df| {err1:.3e} (av rel {av1:.3e}); "
              f"{N_STEPS} steps max|df| {errn:.3e}, av rel {avn:.3e}; against the "
              f"torch.sum plain version: 1 step {old1:.3e}, {N_STEPS} steps {oldn:.3e}, av rel "
              f"{oldavn:.3e}; launches +{launched}")
        require(launched == 1 + N_STEPS, f"{nx}x{ny}: launch count {launched}")
        _check(f"one-step {nx}x{ny}", err1, errn, avn, kn)
        _check(f"one-step {nx}x{ny} vs torch.sum plain", old1, oldn, oldavn, kn)
        rec["by_shape"][f"{nx}x{ny}"] = {
            "err_1": err1, "err_1000": errn, "av_rtol_1000": avn,
            "sum_plain_err_1": old1, "sum_plain_err_1000": oldn,
            "sum_plain_av_rtol_1000": oldavn,
        }
        rec["max_abs_err"] = max(rec["max_abs_err"], err1)
        rec["max_abs_err_1000"] = max(rec["max_abs_err_1000"], errn)
        rec["av_rtol_1000"] = max(rec["av_rtol_1000"], avn)

        if (ny, nx) in TIMED_SHAPES:
            def kernel(n):
                _run_kernel(step, f0, n, torch)

            def checked(n):
                _run_checked(step, f0, n, torch)

            def plain(n):
                _run_plain(step, f0, n, torch)

            # Turns: plain, kernel, checked, checked, kernel, plain; the
            # mean of each pair.
            p_a = _ms_per_step(plain, 200, torch)
            k_a = _ms_per_step(kernel, 2000, torch)
            c_a = _ms_per_step(checked, 2000, torch)
            c_b = _ms_per_step(checked, 2000, torch)
            k_b = _ms_per_step(kernel, 2000, torch)
            p_b = _ms_per_step(plain, 200, torch)
            k_ms, c_ms, p_ms = (k_a + k_b) / 2, (c_a + c_b) / 2, (p_a + p_b) / 2
            kprof = _device_profile(kernel, 500, torch, calls=500)
            pprof = _device_profile(plain, 50, torch)
            dev_us = kprof["device_us"]
            gbs = (BYTES_PER_CELL * ny * nx / (dev_us * 1e-6) / 1e9
                   if dev_us else None)
            rec["timing"][f"{nx}x{ny}"] = {
                "ms": k_ms, "plain_ms": p_ms, "ms_runs": [k_a, k_b],
                "plain_ms_runs": [p_a, p_b], "checked_ms_runs": [c_a, c_b],
                "kernel_profile": kprof,
                "plain_profile": pprof, "device_gbs_at_73B": gbs,
            }
            print(f"one-step {nx}x{ny}: per step, CUDA events over the launch loop: "
                  f"kernel {k_ms * 1e3:.2f} us ({k_a * 1e3:.2f}, {k_b * 1e3:.2f}), "
                  f"plain torch {p_ms * 1e3:.2f} us ({p_a * 1e3:.2f}, "
                  f"{p_b * 1e3:.2f}); kernel checked per launch {c_ms * 1e3:.2f} "
                  f"us ({c_a * 1e3:.2f}, {c_b * 1e3:.2f}) | {card}")
            print(f"one-step {nx}x{ny}: profiler: kernel device {dev_us} us/step of "
                  f"{kprof['wall_us']:.2f} us wall (busy {kprof['busy_share']}), "
                  f"{gbs} GB/s at {BYTES_PER_CELL} B/cell, by kernel "
                  f"{kprof['by_kernel_us']}; plain device {pprof['device_us']} "
                  f"us/step of {pprof['wall_us']:.2f} us wall | {card}")
    return rec


def phase_multi(torch, card: str, seed0: int) -> dict:
    """The three multi-step kernels at the odd shapes and the three small
    canonical grids, chunk 8 and 200: the grid-barrier kernel against
    ``chunk`` plain one-steps per launch; the cluster and bands kernels
    against their plain version (the band algorithm at their bands and
    threads: f bitwise, av within TOL_AV_CLUSTER relative), against the
    grid-barrier kernel from the same inputs (f bitwise after one launch
    and after N_STEPS steps, av within TOL_AV_CLUSTER) and against N_STEPS
    plain one-steps; the first launch of each kernel's N_STEPS run
    repeats its one-launch run: f and av the same bits."""
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops import fused

    dev = torch.device("cuda", 0)
    names = LAUNCH_NAMES
    recs = {name: {"max_abs_err": 0.0, "max_abs_err_1000": 0.0, "av_rtol_1000": 0.0,
                   "by_shape": {}} for name in names.values()}
    for route in ("cluster", "bands"):
        recs[names[route]].update(max_av_rtol=0.0, max_av_rtol_grid=0.0)
    shapes = ODD_SHAPES + tuple(CANONICAL_PARAMS[c].shape for c in SMALL_CASES)
    for seed, (ny, nx) in enumerate(shapes, start=seed0):
        params, obstacles, fcinv, f0 = _setup(ny, nx, seed, dev, torch)
        ref = fused.FusedStep(params, obstacles, fcinv, dev)
        plain_n, plain_avn = _run_plain_steps(ref, f0, N_STEPS, torch)
        for chunk in MULTI_CHUNKS:
            out = {}
            for route, name in names.items():
                prog = fused.MultiStep(params, obstacles, fcinv, dev, chunk, route=route)
                before = fused.LAUNCHES[name]
                k1, kav1 = _run_kernel(prog, f0, 1, torch)
                kn, kavn = _run_kernel(prog, f0, N_STEPS // chunk, torch)
                torch.cuda.synchronize()
                launched = fused.LAUNCHES[name] - before
                p1, pav1 = _run_plain(prog, f0, 1, torch)
                err1, av1 = _errs(k1, kav1, p1, pav1)
                errn, avn = _errs(kn, kavn, plain_n, plain_avn)
                repeat = bool(torch.equal(kav1.view(torch.int32),
                                          kavn[:chunk].view(torch.int32)))
                label = f"{name} {nx}x{ny} chunk {chunk}"
                blocks = prog.nblocks or prog.cluster
                print(f"{label} ({blocks} blocks of {prog.threads or 256} threads): 1 launch "
                      f"against its plain version max|df| {err1:.3e} (av rel {av1:.3e}); "
                      f"{N_STEPS} steps against plain one-steps max|df| {errn:.3e}, av rel "
                      f"{avn:.3e}; launches +{launched}; a launch repeated: av bitwise "
                      f"{repeat}")
                require(launched == 1 + N_STEPS // chunk, f"{label}: launch count {launched}")
                require(repeat, f"{label}: a repeated launch gave other av bits")
                _check(label, err1, errn, avn, kn)
                rec = recs[name]
                rec["by_shape"][f"{nx}x{ny}/{chunk}"] = {
                    "err_1": err1, "av_rtol_1": av1, "err_1000": errn, "av_rtol_1000": avn,
                    "blocks": blocks}
                rec["max_abs_err"] = max(rec["max_abs_err"], err1)
                rec["max_abs_err_1000"] = max(rec["max_abs_err_1000"], errn)
                rec["av_rtol_1000"] = max(rec["av_rtol_1000"], avn)
                out[route] = (k1, kav1, kn, kavn, err1, av1)
            g1, gav1, gn, gavn = out["grid"][:4]
            for route in ("cluster", "bands"):
                k1, kav1, kn, kavn, err1, av1 = out[route]
                gerr1, gav_rel1 = _errs(k1, kav1, g1, gav1)
                gerrn, gav_reln = _errs(kn, kavn, gn, gavn)
                label = f"{names[route]} {nx}x{ny} chunk {chunk}"
                print(f"{label}: against lbm_multi_step from the same inputs, 1 launch "
                      f"max|df| {gerr1:.3e} (av rel {gav_rel1:.3e}), {N_STEPS} steps max|df| "
                      f"{gerrn:.3e} (av rel {gav_reln:.3e})")
                require(err1 == 0.0, f"{label}: f not bitwise its plain version ({err1})")
                require(av1 <= TOL_AV_CLUSTER, f"{label}: av rel {av1} to its plain version")
                require(gerr1 == gerrn == 0.0,
                        f"{label}: f not bitwise lbm_multi_step's ({gerr1}, {gerrn})")
                require(max(gav_rel1, gav_reln) <= TOL_AV_CLUSTER,
                        f"{label}: av rel {gav_rel1}, {gav_reln} to lbm_multi_step's")
                rec = recs[names[route]]
                rec["by_shape"][f"{nx}x{ny}/{chunk}"].update(
                    grid_err_1=gerr1, grid_av_rtol_1=gav_rel1, grid_err_1000=gerrn,
                    grid_av_rtol_1000=gav_reln)
                rec["max_av_rtol"] = max(rec["max_av_rtol"], av1)
                rec["max_av_rtol_grid"] = max(rec["max_av_rtol_grid"], gav_rel1, gav_reln)
            del out
    return recs


def phase_temporal(torch, card: str, seed0: int) -> dict:
    """The persistent temporal kernel against its plain version (the window
    algorithm in torch) and against K plain one-steps per pass: f bitwise
    after one launch and after N_STEPS steps, av as every kernel's."""
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops import fused, schedule

    dev = torch.device("cuda", 0)
    big = CANONICAL_PARAMS["1024x1024"]
    chosen = schedule.choose_temporal(big.ny, big.nx, big.max_iters)
    require(chosen is not None, "no temporal tiling for 1024x1024 x 20000")
    rec = {"max_abs_err": 0.0, "max_abs_err_1000": 0.0, "av_rtol_1000": 0.0,
           "by_shape": {}, "chosen": chosen}
    grids = ((big.ny, big.nx, *chosen, 0),) + TEMPORAL_SMALL
    for seed, (ny, nx, by, bx, k, offset) in enumerate(grids, start=seed0):
        params, obstacles, fcinv, f0 = _setup(ny, nx, seed, dev, torch)
        prog = fused.TemporalStep(params, obstacles, fcinv, dev, by, bx, k)
        tiles = (ny // by) * (nx // bx)
        passes = -(-N_STEPS // k)
        before = fused.LAUNCHES["lbm_temporal_step"]
        k1, kav1 = _run_kernel(prog, f0, 1, torch, offset)
        kn, kavn = _run_kernel(prog, f0, passes, torch, offset)
        torch.cuda.synchronize()
        launched = fused.LAUNCHES["lbm_temporal_step"] - before
        p1, pav1 = _run_plain(prog, f0, 1, torch)
        pn, pavn = _run_plain(prog, f0, passes, torch)
        s1, sav1 = _run_plain_steps(prog, f0, k, torch)
        sn, savn = _run_plain_steps(prog, f0, passes * k, torch)
        err1, av1 = _errs(k1, kav1, p1, pav1)
        errn, avn = _errs(kn, kavn, pn, pavn)
        serr1, _ = _errs(k1, kav1, s1, sav1)
        serrn, savn_rel = _errs(kn, kavn, sn, savn)
        label = f"temporal {nx}x{ny} tile {by}x{bx} K {k}, f at offset {offset}"
        print(f"{label} ({tiles} tiles on {prog.nblocks} persistent blocks, "
              f"{tiles % prog.nblocks} left over): against its plain version 1 pass "
              f"max|df| {err1:.3e} (av rel {av1:.3e}), {passes * k} steps max|df| "
              f"{errn:.3e}, av rel {avn:.3e}; against plain one-steps 1 pass "
              f"{serr1:.3e}, {passes * k} steps {serrn:.3e}, av rel {savn_rel:.3e}; "
              f"launches +{launched}")
        require(launched == 1 + passes, f"{label}: launch count {launched}")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        require(1 <= prog.nblocks <= tiles
                and (prog.nblocks == tiles or prog.nblocks % sms == 0),
                f"{label}: grid {prog.nblocks} for {tiles} tiles on {sms} SMs")
        _check(label, err1, errn, avn, kn)
        _check(f"{label} vs one-steps", serr1, serrn, savn_rel, kn)
        require(err1 == errn == serr1 == serrn == 0.0, f"{label}: f not bitwise")
        rec["by_shape"][f"{nx}x{ny}/{by}x{bx}/K{k}/offset{offset}"] = {
            "err_1": err1, "err_1000": errn, "av_rtol_1000": avn,
            "one_step_err_1": serr1, "one_step_err_1000": serrn,
            "one_step_av_rtol_1000": savn_rel}
        rec["max_abs_err"] = max(rec["max_abs_err"], err1, serr1)
        rec["max_abs_err_1000"] = max(rec["max_abs_err_1000"], errn, serrn)
        rec["av_rtol_1000"] = max(rec["av_rtol_1000"], avn, savn_rel)
    return rec


def _inplace_programs(params, obstacles, fcinv, dev, by, bx, k, tpasses):
    from lbm_tpu_torch.ops import fused

    return (fused.TemporalXtStep(params, obstacles, fcinv, dev, by, bx, k),
            fused.MegaStep(params, obstacles, fcinv, dev, by, bx, k, tpasses))


def _check_inplace(label, k, kav, p, pav, rec, suffix=""):
    """f bitwise and av within TOL_AV_INPLACE of (p, pav); the worst kept
    in ``rec["max_abs_err" + suffix]`` and ``rec["max_av_rtol" + suffix]``."""
    err = (k - p).abs().max().item()
    av = ((kav - pav).abs() / pav.abs()).max().item()
    require(bool(k.isfinite().all()), f"{label}: non-finite f")
    require(err == 0.0, f"{label}: max|df| {err}, not bitwise")
    require(av <= TOL_AV_INPLACE, f"{label}: av rel {av} > {TOL_AV_INPLACE}")
    rec["max_abs_err" + suffix] = max(rec["max_abs_err" + suffix], err)
    rec["max_av_rtol" + suffix] = max(rec["max_av_rtol" + suffix], av)
    return err, av


def _grid_text(prog) -> str:
    """A persistent or cooperative program's grid: its tiles on its blocks."""
    tiles = prog.tiles[0] * prog.tiles[1]
    return (f"{tiles} tiles on {prog.nblocks} blocks ({tiles // prog.nblocks} a block, "
            f"{tiles % prog.nblocks} left over)")


def phase_inplace(torch, card: str, seed0: int) -> dict:
    """The x-tiled kernel and the megakernel against their plain versions
    (the band algorithm in torch) and against K (T*K) plain one-steps: at
    the odd shapes (INPLACE_SMALL, and INPLACE_PREFETCH, where both
    kernels' persistent blocks walk at least three tiles each) after one
    launch and after 1000 steps, and at the main path's shapes (8192^2
    x-tiled, 1024^2 mega) after one launch; at 8192^2 the x-tiled pass
    also bitwise against the row temporal kernel's at the same tile and
    K, and at 1024^2 one megakernel launch bitwise against T x-tiled
    launches.  Each kernel's grid is printed."""
    import numpy as np

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import free_cells_of
    from lbm_tpu_torch.ops import fused, schedule
    from lbm_tpu_torch.ops.reference import init_cells
    from lbm_tpu_torch.runtime import make_program
    from lbm_tpu_torch.tools import validate_giant

    dev = torch.device("cuda", 0)
    recs = {}
    for name in ("lbm_temporal_xt_step", "lbm_mega_step"):
        recs[name] = {"max_abs_err": 0.0, "max_av_rtol": 0.0, "max_abs_err_1000": 0.0,
                      "max_av_rtol_1000": 0.0, "by_shape": {}}
    for seed, shape in enumerate(INPLACE_SMALL + INPLACE_PREFETCH, start=seed0):
        ny, nx, by, bx, k, t = shape
        params, obstacles, fcinv, f0 = _setup(ny, nx, seed, dev, torch)
        progs = _inplace_programs(params, obstacles, fcinv, dev, by, bx, k, t)
        for prog in progs if shape in INPLACE_PREFETCH else ():
            require(prog.tiles[0] * prog.tiles[1] >= PREFETCH_TILES_A_BLOCK * prog.nblocks,
                    f"{type(prog).__name__} {nx}x{ny}: {_grid_text(prog)}, fewer than "
                    f"{PREFETCH_TILES_A_BLOCK} tiles a block")
        for prog in progs:
            name = ("lbm_mega_step" if isinstance(prog, fused.MegaStep)
                    else "lbm_temporal_xt_step")
            launches = -(-N_STEPS // prog.chunk)
            before = fused.LAUNCHES[name]
            k1, kav1 = _run_kernel(prog, f0, 1, torch)
            kn, kavn = _run_kernel(prog, f0, launches, torch)
            torch.cuda.synchronize()
            launched = fused.LAUNCHES[name] - before
            p1, pav1 = _run_plain(prog, f0, 1, torch)
            pn, pavn = _run_plain(prog, f0, launches, torch)
            s1, sav1 = _run_plain_steps(prog, f0, prog.chunk, torch)
            sn, savn = _run_plain_steps(prog, f0, launches * prog.chunk, torch)
            label = f"{name} {nx}x{ny} tile {by}x{bx} K {k} x{prog.chunk // k}"
            rec = recs[name]
            steps = launches * prog.chunk
            errs = [_check_inplace(f"{label} 1 launch", k1, kav1, p1, pav1, rec),
                    _check_inplace(f"{label} {steps} steps", kn, kavn, pn, pavn, rec,
                                   "_1000"),
                    _check_inplace(f"{label} vs one-steps, 1 launch", k1, kav1, s1,
                                   sav1, rec),
                    _check_inplace(f"{label} vs one-steps, {steps} steps", kn, kavn, sn,
                                   savn, rec, "_1000")]
            require(launched == 1 + launches, f"{label}: launch count {launched}")
            rec["by_shape"][f"{nx}x{ny}/{by}x{bx}/K{k}/T{prog.chunk // k}"] = errs
            print(f"{label}: max|df| and av rel against its plain version, 1 launch "
                  f"{errs[0]}, {launches * prog.chunk} steps {errs[1]}; against plain "
                  f"one-steps {errs[2]}, {errs[3]}; launches +{launched}; grid "
                  f"{_grid_text(prog)}")

    # The main path's shapes, one launch each.
    big = CANONICAL_PARAMS["1024x1024"]
    params, obstacles, fcinv, f0 = _setup(
        big.ny, big.nx, seed0 + len(INPLACE_SMALL) + len(INPLACE_PREFETCH), dev, torch)
    mega = make_program(params, obstacles, fcinv, "mega", dev, max_iters=big.max_iters)
    require(isinstance(mega, fused.MegaStep), "1024x1024 x 20000 --kernel mega: no split")
    n = 8192
    gparams, gobstacles = validate_giant.setup(n, 20000)
    gfcinv = np.float32(1.0) / np.float32(free_cells_of(gobstacles))
    xt = fused.TemporalXtStep(gparams, gobstacles, gfcinv, dev,
                              *schedule.choose_temporal_xtiled(n, n, 20000))
    # Two launches from the uniform state first: the launch held against
    # the plain version starts from non-uniform bands.
    g0, _ = _run_kernel(xt, init_cells(gparams, dev), 2, torch)
    for prog, start, shape in ((mega, f0, "1024x1024"), (xt, g0, f"{n}x{n}")):
        name = "lbm_mega_step" if prog is mega else "lbm_temporal_xt_step"
        k1, kav1 = _run_kernel(prog, start, 1, torch)
        p1, pav1 = _run_plain(prog, start, 1, torch)
        s1, sav1 = _run_plain_steps(prog, start, prog.chunk, torch)
        rec = recs[name]
        label = f"{name} {shape} tile {prog.by}x{prog.bx} K {prog.ksteps} x{prog.tpasses}"
        errs = [_check_inplace(f"{label} 1 launch", k1, kav1, p1, pav1, rec),
                _check_inplace(f"{label} vs one-steps", k1, kav1, s1, sav1, rec)]
        rec["by_shape"][shape] = errs
        rec["main_shape"] = {"shape": shape, "tile": [prog.by, prog.bx],
                             "k": prog.ksteps, "tpasses": prog.tpasses}
        print(f"{label}: one launch against its plain version {errs[0]}, against "
              f"{prog.chunk} plain one-steps {errs[1]}; grid {_grid_text(prog)}")
        del k1, p1, s1
    # The same pass by the row temporal kernel (ping-pong) at the same tile
    # and K: the in-place design changes where the halo comes from, not f.
    temporal = fused.TemporalStep(gparams, gobstacles, gfcinv, dev, xt.by, xt.bx, xt.ksteps)
    k1, _ = _run_kernel(xt, g0, 1, torch)
    t1, _ = _run_kernel(temporal, g0, 1, torch)
    same = torch.equal(k1.view(torch.int32), t1.view(torch.int32))
    print(f"lbm_temporal_xt_step {n}x{n}: one pass bitwise the row temporal kernel's at "
          f"tile {xt.by}x{xt.bx}, K {xt.ksteps}: {same} (temporal grid {temporal.nblocks} "
          f"blocks)")
    require(same, f"{n}x{n}: the x-tiled pass differs from the row temporal kernel's")
    recs["lbm_temporal_xt_step"]["bitwise_row_temporal_8192"] = same
    recs["lbm_temporal_xt_step"]["grid_8192"] = [xt.tiles[0] * xt.tiles[1], xt.nblocks]
    del k1, t1, temporal
    # One megakernel launch against T x-tiled launches at the same tile: a
    # grid barrier in place of each launch boundary changes nothing in f.
    xt1 = fused.TemporalXtStep(params, obstacles, fcinv, dev, mega.by, mega.bx, mega.ksteps)
    m1, mav = _run_kernel(mega, f0, 1, torch)
    x1, xav = _run_kernel(xt1, f0, mega.tpasses, torch)
    same = torch.equal(m1.view(torch.int32), x1.view(torch.int32))
    av_rel = ((mav - xav).abs() / xav.abs()).max().item()
    print(f"lbm_mega_step 1024x1024: one launch (T {mega.tpasses}) bitwise {mega.tpasses} "
          f"x-tiled launches at tile {mega.by}x{mega.bx}, K {mega.ksteps}: {same}, av rel "
          f"{av_rel:.3e} (x-tiled grid {xt1.nblocks} blocks, mega {mega.nblocks})")
    require(same, "1024x1024: a megakernel launch differs from its T x-tiled launches")
    require(av_rel <= TOL_AV_INPLACE, f"1024x1024: mega av rel {av_rel} against x-tiled")
    recs["lbm_mega_step"]["bitwise_xtiled_launches_1024"] = same
    recs["lbm_mega_step"]["grid_1024"] = [mega.tiles[0] * mega.tiles[1], mega.nblocks]
    return recs


def _report_turns(label, times, profiles, card):
    for name, runs in times.items():
        mean = sum(runs) / len(runs)
        prof = profiles[name]
        print(f"{label} {name}: {mean * 1e3:.3f} us/step by CUDA events, turns "
              f"{[round(r * 1e3, 3) for r in runs]}; profiler device "
              f"{prof['device_us']} us/step of {prof['wall_us']:.2f} us wall (busy "
              f"{prof['busy_share']}), by kernel {prof['by_kernel_us']}, calls recorded "
              f"{prof['recorded_calls']} of {prof['expected_calls']} | {card}")


def phase_timing(torch, card: str) -> dict:
    """Each new kernel against the one-step kernel it replaces on the main
    path, in one call, in turns (A, B, C, C, B, A)."""
    from lbm_tpu_torch.ops import fused, schedule

    dev = torch.device("cuda", 0)
    rec = {}

    # 128x128: A the bound one-step loop, B the grid-barrier multi-step
    # kernel (chunk 200, as the main path takes it for 40,000 steps), C a
    # CUDA graph of GRAPH_STEPS bound one-step launches, replayed.
    params, obstacles, fcinv, f0 = _setup(128, 128, 2, dev, torch)
    one = fused.FusedStep(params, obstacles, fcinv, dev)
    chunk = schedule.pick_chunk(40000)
    multi = fused.MultiStep(params, obstacles, fcinv, dev, chunk, route="grid")
    gbufs = (f0.clone(), torch.empty_like(f0))
    gav = torch.empty(GRAPH_STEPS, dtype=torch.float32, device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        glaunch = one.bind(gbufs[0], gbufs[1], gav)
        for t in range(GRAPH_STEPS):
            glaunch(t)
    runs = {
        "A one-step loop": lambda n: _run_kernel(one, f0, n, torch),
        "B multi-step": lambda n: _run_kernel(multi, f0, n // chunk, torch),
        "C graph of one-steps": lambda n: [graph.replay()
                                           for _ in range(n // GRAPH_STEPS)],
    }
    names = list(runs)
    n = 8000
    steps = dict.fromkeys(names, n)
    warm = dict.fromkeys(names, 2 * GRAPH_STEPS)
    times = _turns(runs, [names[i] for i in (0, 1, 2, 2, 1, 0)], steps, torch, warm)
    calls = dict(zip(names, (2000, 2000 // chunk, 2000)))
    profiles = {name: _device_profile(runs[name], 2000, torch, warm[name], calls[name])
                for name in names}
    _report_turns("128x128", times, profiles, card)
    rec["128x128"] = {"times_ms": times, "profiles": profiles, "chunk": chunk,
                      "multi_blocks": multi.nblocks}
    del graph

    # 1024x1024: A the one-step kernel, B the temporal kernel at the chosen
    # tiling, C the temporal kernel at another K.
    params, obstacles, fcinv, f0 = _setup(1024, 1024, 5, dev, torch)
    one = fused.FusedStep(params, obstacles, fcinv, dev)
    by, bx, k = schedule.choose_temporal(1024, 1024, 20000)
    k_other = 4 if k != 4 else 8
    other = next((t for t in schedule.TEMPORAL_TILES
                  if schedule.persistent_fits(*t, k_other)))
    temporal = fused.TemporalStep(params, obstacles, fcinv, dev, by, bx, k)
    temporal_other = fused.TemporalStep(params, obstacles, fcinv, dev, *other, k_other)
    a, b, c = ("A one-step", f"B temporal {by}x{bx} K{k}",
               f"C temporal {other[0]}x{other[1]} K{k_other}")
    runs = {
        a: lambda n: _run_kernel(one, f0, n, torch),
        b: lambda n: _run_kernel(temporal, f0, n // k, torch),
        c: lambda n: _run_kernel(temporal_other, f0, n // k_other, torch),
    }
    steps = dict.fromkeys(runs, 800)
    warm = dict.fromkeys(runs, 16)
    times = _turns(runs, [a, b, c, c, b, a], steps, torch, warm)
    calls = dict(zip(runs, (400, 400 // k, 400 // k_other)))
    profiles = {name: _device_profile(runs[name], 400, torch, warm[name], calls[name])
                for name in runs}
    _report_turns("1024x1024", times, profiles, card)
    ratio = sum(times[b]) / sum(times[a])
    print(f"1024x1024 temporal {by}x{bx} K{k} against the one-step kernel in the same "
          f"turns: ratio {ratio:.4f} | {card}")

    # Every tile of SWEEP_TILES at every K of the fixed order whose windows
    # fit.
    sweep = {}
    for kk in schedule.TEMPORAL_K:
        for tile in SWEEP_TILES:
            if not schedule.persistent_fits(*tile, kk):
                continue
            prog = fused.TemporalStep(params, obstacles, fcinv, dev, *tile, kk)
            sweep[f"{tile[0]}x{tile[1]} K{kk}"] = _ms_per_step(
                lambda n, prog=prog, kk=kk: _run_kernel(prog, f0, n // kk, torch),
                800, torch, 16)
    print("1024x1024 temporal tilings, us/step by CUDA events, fastest first: "
          + ", ".join(f"{name} {ms * 1e3:.2f}"
                      for name, ms in sorted(sweep.items(), key=lambda kv: kv[1]))
          + f" | {card}")

    def plain_temporal(n):
        _run_plain(temporal, f0, n // k, torch)

    p_ms = [_ms_per_step(plain_temporal, 64, torch, 16) for _ in range(2)]
    print(f"1024x1024 plain temporal (window algorithm in torch): "
          f"{sum(p_ms) / 2 * 1e3:.2f} us/step ({p_ms[0] * 1e3:.2f}, "
          f"{p_ms[1] * 1e3:.2f}) | {card}")
    rec["1024x1024"] = {"times_ms": times, "profiles": profiles,
                        "chosen": [by, bx, k], "other": [*other, k_other],
                        "ratio_to_one_step": ratio,
                        "tile_sweep_ms": sweep,
                        "plain_temporal_ms_runs": p_ms}

    # The grid-barrier kernel's plain version at 128x128: plain one-steps.
    params, obstacles, fcinv, f0 = _setup(128, 128, 2, dev, torch)
    multi = fused.MultiStep(params, obstacles, fcinv, dev, 8, route="grid")
    p_ms = [_ms_per_step(lambda n: _run_plain(multi, f0, n // 8, torch), 200,
                         torch, 16) for _ in range(2)]
    rec["128x128"]["plain_multi_ms_runs"] = p_ms
    print(f"128x128 plain multi-step (chunk plain one-steps): "
          f"{sum(p_ms) / 2 * 1e3:.2f} us/step | {card}")
    return rec


def phase_cluster_timing(torch, card: str) -> dict:
    """The three multi-step kernels in turns (A grid barrier, B cluster, C
    bands, C, B, A) at the three small canonical grids from one state,
    chunk 200 as the main path takes them, by CUDA events over the bound
    launch loop, with profiler device time; the band algorithm (the
    cluster and bands kernels' plain version) at 128x128 and 256x256; and
    the synchronisation probe, BARRIER_STEPS steps of it alone:
    ``grid.sync()`` over the grid kernel's blocks at 128x128 and 256x256,
    the cluster barrier over 16 blocks, the cluster kernel's ghost-row
    exchange over 16 blocks at the widths 128 and 256, and the bands
    kernel's handoff through device memory over its blocks at the widths
    128 and 256 (what a step costs besides the update), then whether the
    card admits that handoff's launch in cooperative clusters of two."""
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops import _build, fused, schedule

    dev = torch.device("cuda", 0)
    rec = {"admission": list(schedule.cluster_admission(dev)),
           "bands_admission": schedule.bands_admission(dev), "grids": {}}
    print(f"cluster admission (cudaOccupancyMaxActiveClusters at {schedule.CLUSTER_SMEM_BUDGET}"
          f" B a block): largest size {rec['admission'][0]} blocks, "
          f"{rec['admission'][1]} such clusters at once; bands admission: "
          f"{rec['bands_admission']} SMs | {card}")
    rec["odd_grids"] = {}
    shapes = [(f"{nx}x{ny}", ny, nx, MULTI_CHUNKS[-1]) for ny, nx in ODD_SHAPES]
    shapes += [(case, *CANONICAL_PARAMS[case].shape,
                schedule.pick_chunk(CANONICAL_PARAMS[case].max_iters)) for case in SMALL_CASES]
    for case, ny, nx, chunk in shapes:
        params, obstacles, fcinv, f0 = _setup(ny, nx, 2, dev, torch)
        progs = {f"{key} {name}": fused.MultiStep(params, obstacles, fcinv, dev, chunk,
                                                  route=route)
                 for key, route, name in (("A", "grid", "lbm_multi_step"),
                                          ("B", "cluster", "lbm_multi_cluster_step"),
                                          ("C", "bands", "lbm_multi_bands_step"))}
        runs = {name: _bound_loop(prog, f0, torch) for name, prog in progs.items()}
        a, b, c = runs
        steps = dict.fromkeys(runs, 8000)
        warm = dict.fromkeys(runs, 2 * chunk)
        times = _turns(runs, [a, b, c, c, b, a], steps, torch, warm)
        route = schedule.multi_route(ny, nx, rec["admission"][0], rec["bands_admission"])
        fastest = min(times, key=lambda name: sum(times[name]))
        require(LAUNCH_NAMES[route] in fastest,
                f"{case}: the route takes {route}, but {fastest} was the fastest in turns")
        if case not in SMALL_CASES:
            rec["odd_grids"][case] = {"times_ms": times, "chunk": chunk, "route": route}
            print(f"{case}: " + "; ".join(f"{name} {sum(t) / len(t) * 1e3:.3f} us/step, turns "
                                          f"{[round(x * 1e3, 3) for x in t]}"
                                          for name, t in times.items())
                  + f"; the route: {route} | {card}")
            continue
        profiles = {name: _device_profile(runs[name], 2000, torch, warm[name],
                                          2000 // chunk) for name in runs}
        _report_turns(case, times, profiles, card)
        cl, bd = progs[b], progs[c]
        print(f"{case}: cluster of {cl.cluster} blocks, bands of "
              f"{sorted({r for _, r in cl.bands})} rows, "
              f"{schedule.cluster_chunks(ny, nx, cl.cluster)} chunk(s) a step, "
              f"{cl.smem_bytes} B of dynamic shared memory a block; bands kernel "
              f"{bd.nblocks} blocks of {bd.threads} threads, bands of "
              f"{sorted({r for _, r in bd.bands})} rows, "
              f"{schedule.bands_chunks(ny, nx, bd.nblocks)} chunk(s) a step, "
              f"{bd.smem_bytes} B a block; lbm_multi_step {progs[a].nblocks} blocks; the "
              f"main path's route: {route} | {card}")
        rec["grids"][case] = {"times_ms": times, "profiles": profiles, "chunk": chunk,
                              "cluster": cl.cluster, "smem_bytes": cl.smem_bytes,
                              "bands_blocks": bd.nblocks, "bands_threads": bd.threads,
                              "bands_smem_bytes": bd.smem_bytes,
                              "grid_blocks": progs[a].nblocks, "route": route}
        if case in ("128x128", "256x256"):
            prog = cl if case == "128x128" else bd
            rec["grids"][case]["plain_ms_runs"] = [
                _ms_per_step(lambda n: _run_plain(prog, f0, n // chunk, torch), chunk,
                             torch, chunk) for _ in range(2)]
            print(f"{case} plain band algorithm ({prog.route} route's bands): "
                  f"{[round(m * 1e3, 1) for m in rec['grids'][case]['plain_ms_runs']]} "
                  f"us/step | {card}")
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rec["barrier_us"] = {}
    g128, g256 = rec["grids"]["128x128"], rec["grids"]["256x256"]
    h128, h256 = rec["grids"]["128x256"]["bands_blocks"], g256["bands_blocks"]
    for key, mode, blocks, nx in (
            (f"grid barrier, {g128['grid_blocks']} blocks", 0, g128["grid_blocks"], 0),
            (f"grid barrier, {g256['grid_blocks']} blocks", 0, g256["grid_blocks"], 0),
            ("cluster barrier, 16 blocks", 1, 16, 0),
            ("ghost-row exchange, 16 blocks, rows 128 wide", 2, 16, 128),
            ("ghost-row exchange, 16 blocks, rows 256 wide", 2, 16, 256),
            (f"handoff through device memory, {h128} blocks, rows 128 wide", 3, h128, 128),
            (f"handoff through device memory, {h256} blocks, rows 256 wide", 3, h256, 256)):
        def probe(n, mode=mode, blocks=blocks, nx=nx):
            for _ in range(n // BARRIER_STEPS):
                rc = lib.lbm_barrier_probe(mode, blocks, nx, BARRIER_STEPS, stream)
                require(rc == 0, f"sync probe: {lib.lbm_error_string(rc).decode()}")

        rec["barrier_us"][key] = [_ms_per_step(probe, 4 * BARRIER_STEPS, torch,
                                               BARRIER_STEPS) * 1e3 for _ in range(2)]
    print("synchronisation probe, us a step (two runs each): "
          + "; ".join(f"{k} {[round(v, 4) for v in us]}"
                      for k, us in rec["barrier_us"].items()) + f" | {card}")
    rc = lib.lbm_barrier_probe(4, h256, 256, BARRIER_STEPS, stream)
    torch.cuda.synchronize()
    rec["cooperative_cluster_launch"] = "admitted" if rc == 0 else \
        f"refused: {lib.lbm_error_string(rc).decode()}"
    print(f"a cooperative launch in clusters of two blocks ({h256} blocks): "
          f"{rec['cooperative_cluster_launch']} | {card}")
    return rec


def _peak_bytes(run, torch) -> int:
    """Device bytes ``run()`` allocates at its peak, above what was
    allocated before it (``torch.cuda.max_memory_allocated``)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_inplace_timing(torch, card: str) -> dict:
    """In one call, in turns (A, B, C, C, B, A): at 8192^2 the x-tiled
    kernel against the row temporal kernel (same tile and K) and the
    one-step kernel; at 1024^2 the megakernel against the temporal kernel
    and the x-tiled kernel at the megakernel's tile (T launch boundaries
    where the megakernel has T - 1 grid barriers).
    CUDA events, profiler device time beside them; the plain versions'
    times; the peak device memory of an x-tiled and a ping-pong run at
    8192^2."""
    import numpy as np

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import free_cells_of
    from lbm_tpu_torch.ops import fused, schedule
    from lbm_tpu_torch.ops.reference import init_cells
    from lbm_tpu_torch.runtime import make_program
    from lbm_tpu_torch.tools import validate_giant

    dev = torch.device("cuda", 0)
    rec = {}
    n = 8192
    params, obstacles = validate_giant.setup(n, 20000)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    by, bx, k = schedule.choose_temporal_xtiled(n, n, 20000)
    xt = fused.TemporalXtStep(params, obstacles, fcinv, dev, by, bx, k)
    temporal = fused.TemporalStep(params, obstacles, fcinv, dev, by, bx, k)
    one = fused.FusedStep(params, obstacles, fcinv, dev)
    f0 = init_cells(params, dev)
    a, b, c = (f"A x-tiled {by}x{bx} K{k}", f"B temporal {by}x{bx} K{k}", "C one-step")
    runs = {a: _bound_loop(xt, f0, torch), b: _bound_loop(temporal, f0, torch),
            c: _bound_loop(one, f0, torch)}
    steps = dict.fromkeys(runs, 200)
    warm = dict.fromkeys(runs, 8)
    times = _turns(runs, [a, b, c, c, b, a], steps, torch, warm)
    calls = dict(zip(runs, (40 // k, 40 // k, 40)))
    profiles = {name: _device_profile(runs[name], 40, torch, warm[name], calls[name])
                for name in runs}
    _report_turns(f"{n}x{n}", times, profiles, card)
    del runs
    p_ms = [_ms_per_step(lambda s: _run_plain(xt, f0, s // k, torch), k, torch, k)
            for _ in range(2)]
    print(f"{n}x{n} plain x-tiled pass (band algorithm in torch): "
          f"{sum(p_ms) / 2 * 1e3:.2f} us/step ({p_ms[0] * 1e3:.2f}, "
          f"{p_ms[1] * 1e3:.2f}) | {card}")

    def run_8(prog, *bufs):
        av = torch.empty(8 * k, dtype=torch.float32, device=dev)
        launch = prog.bind(*bufs, av)
        for i in range(8):
            launch(i)

    def xt_run():  # as Simulator.run binds it: one f buffer and the bands
        run_8(xt, init_cells(params, dev))

    def pingpong_run():
        f = init_cells(params, dev)
        run_8(temporal, f, torch.empty_like(f))

    del f0
    peak = {"x-tiled": _peak_bytes(xt_run, torch), "ping-pong temporal": _peak_bytes(
        pingpong_run, torch)}
    f_bytes = 9 * n * n * 4
    print(f"{n}x{n} peak device memory of a run (init, bind, 8 launches): "
          + ", ".join(f"{name} {v} B ({v / f_bytes:.4f} f)" for name, v in peak.items())
          + f"; f is {f_bytes} B | {card}")
    require(peak["x-tiled"] < peak["ping-pong temporal"],
            f"the x-tiled run's peak {peak['x-tiled']} B is not below the ping-pong "
            f"run's {peak['ping-pong temporal']} B")
    rec[f"{n}x{n}"] = {"times_ms": times, "profiles": profiles, "tile": [by, bx, k],
                       "plain_xt_ms_runs": p_ms, "peak_bytes": peak, "f_bytes": f_bytes,
                       "band_floats": xt.band_floats, "cells": n * n}
    del xt, temporal, one

    big = CANONICAL_PARAMS["1024x1024"]
    params, obstacles, fcinv, f0 = _setup(big.ny, big.nx, 5, dev, torch)
    mega = make_program(params, obstacles, fcinv, "mega", dev, max_iters=big.max_iters)
    temporal = fused.TemporalStep(params, obstacles, fcinv, dev,
                                  *schedule.choose_temporal(big.ny, big.nx, big.max_iters))
    xt = fused.TemporalXtStep(params, obstacles, fcinv, dev, mega.by, mega.bx, mega.ksteps)
    a, b, c = (f"A mega {mega.by}x{mega.bx} K{mega.ksteps} T{mega.tpasses}",
               f"B temporal {temporal.by}x{temporal.bx} K{temporal.chunk}",
               f"C x-tiled {xt.by}x{xt.bx} K{xt.ksteps}")
    runs = {a: _bound_loop(mega, f0, torch, cap=8), b: _bound_loop(temporal, f0, torch),
            c: _bound_loop(xt, f0, torch)}
    steps = dict.fromkeys(runs, 2000)
    warm = dict.fromkeys(runs, 200)
    times = _turns(runs, [a, b, c, c, b, a], steps, torch, warm)
    calls = dict(zip(runs, (2000 // mega.chunk, 2000 // temporal.chunk, 2000 // xt.chunk)))
    profiles = {name: _device_profile(runs[name], 2000, torch, warm[name], calls[name])
                for name in runs}
    _report_turns("1024x1024", times, profiles, card)
    p_ms = [_ms_per_step(lambda s: _run_plain(mega, f0, s // mega.chunk, torch),
                         mega.chunk, torch, mega.chunk) for _ in range(2)]
    print(f"1024x1024 plain mega launch (T band-algorithm passes in torch): "
          f"{sum(p_ms) / 2 * 1e3:.2f} us/step ({p_ms[0] * 1e3:.2f}, "
          f"{p_ms[1] * 1e3:.2f}) | {card}")
    rec["1024x1024"] = {"times_ms": times, "profiles": profiles,
                        "mega": [mega.by, mega.bx, mega.ksteps, mega.tpasses],
                        "blocks": mega.nblocks, "plain_mega_ms_runs": p_ms,
                        "band_floats": mega.band_floats, "cells": big.ny * big.nx}
    return rec


@contextlib.contextmanager
def _no_room_for_pingpong():
    """Route runs as on a card that holds the in-place state of a grid but
    not its ping-pong pair: ``runtime.hbm_budget_gib`` is 0 inside, so the
    schedule takes the x-tiled kernel where ``lbm_tpu``'s gate admits the
    grid, and a checkpointed run the carry-resident driver."""
    from lbm_tpu_torch import runtime

    budget = runtime.hbm_budget_gib
    runtime.hbm_budget_gib = lambda device: 0.0
    try:
        yield
    finally:
        runtime.hbm_budget_gib = budget


def phase_giant(torch, card: str) -> dict:
    """``validate_giant``'s three phases: ``kernel`` and ``fields`` at
    8192^2 and 16384^2, ``ckpt`` fresh then resume at 8192^2, the resumed
    run's av and f bitwise equal to an uninterrupted run.  The ``fields``
    runs and one ``ckpt`` pair route as on a card without room for the
    ping-pong pair (x-tiled, carry-resident); the other ``ckpt`` pair takes
    this card's own schedule (row temporal, f between segments).  Every
    launch of these runs is counted."""
    import shutil

    import numpy as np

    from lbm_tpu_torch.ops import fused, schedule
    from lbm_tpu_torch.runtime import Simulator, hbm_budget_gib, state_readback_fits
    from lbm_tpu_torch.tools import validate_giant as vg

    dev = torch.device("cuda", 0)
    rec = {"kernel": {}, "fields": {}, "ckpt": {},
           "launches": dict.fromkeys(fused.LAUNCHES, 0)}
    for n in GIANT_SIZES:
        r = vg.kernel(n, GIANT_STEPS)
        print(f"validate_giant kernel {n}^2: tile {r['tile']} K {r['k']}, "
              f"{r['us_per_step']:.3f} us/step, {r['glups']:.3f} GLUPS; one launch "
              f"against its plain version: f equal {r['f_equal_plain']}, av rel "
              f"{r['av_rel_plain']:.3e} | {card}", flush=True)
        require(r["ok"], f"validate_giant kernel {n}^2 failed: {r}")
        rec["kernel"][n] = r
        torch.cuda.empty_cache()

    def counted(label, fn, name, expected):
        fused.reset_launches()
        out = fn()
        launches = dict(fused.LAUNCHES)
        want = dict.fromkeys(fused.LAUNCHES, 0)
        want[name] = expected
        require(launches == want, f"{label}: launches {launches}, expected {want}")
        for kernel, count in launches.items():
            rec["launches"][kernel] += count
        return out

    for n in GIANT_SIZES:
        own = schedule.choose_schedule(
            n, n, GIANT_STEPS, pingpong_fits=state_readback_fits(n, n, hbm_budget_gib(dev)))
        print(f"schedule of {n}^2 x {GIANT_STEPS} on this card: {own}", flush=True)
        require(own[0] == "temporal", f"{n}^2 on this card: {own}, not the row temporal "
                                      "kernel")
        k = schedule.choose_temporal_xtiled(n, n, GIANT_STEPS)[2]
        split: dict = {}
        tic = time.perf_counter()
        with _no_room_for_pingpong(), _timing_expand(split):
            r = counted(f"fields {n}^2", lambda: vg.fields(n, GIANT_STEPS, dev),
                        "lbm_temporal_xt_step", GIANT_STEPS // k)
        total = time.perf_counter() - tic
        print(f"validate_giant fields {n}^2 x{GIANT_STEPS} through {r['program']}: "
              f"elapsed {r['elapsed_s']:.6f} s ({r['mlups']:.1f} MLUPS), wall "
              f"{r['wall_s']:.3f} s, av[-1] {r['av_last']:.9e} | {card}", flush=True)
        if n == GIANT_SPLIT:
            # vg.fields makes its Simulator before its wall clock starts;
            # the rest of its wall time is the program's construction and
            # buffers in Simulator.run and the tool's finiteness checks.
            r["split"] = {"setup_and_simulator": total - r["wall_s"],
                          "timed_loop": r["elapsed_s"],
                          "expand_fields": split["expand_fields"],
                          "rest_of_run_and_checks": (r["wall_s"] - r["elapsed_s"]
                                                     - split["expand_fields"])}
            for name, sec in r["split"].items():
                print(f"split validate_giant fields {n}^2 x{GIANT_STEPS}: {name} "
                      f"{sec:.6f} s | {card}", flush=True)
        require(r["ok"] and r["program"] == "TemporalXtStep",
                f"validate_giant fields {n}^2 failed: {r}")
        rec["fields"][n] = r
        torch.cuda.empty_cache()

    n = GIANT_SIZES[0]
    k = schedule.choose_temporal_xtiled(n, n, GIANT_STEPS)[2]
    params, obstacles = vg.setup(n, 2 * GIANT_STEPS)
    whole = Simulator(params, obstacles, device=dev).run(readback="state")
    d = WORK / "giant_ckpt"
    for driver, route, name in (
            ("f between segments", contextlib.nullcontext, "lbm_temporal_step"),
            ("carry-resident", _no_room_for_pingpong, "lbm_temporal_xt_step")):
        shutil.rmtree(d, ignore_errors=True)
        with route():
            fresh = counted(f"ckpt fresh, {driver}",
                            lambda: vg.ckpt(n, GIANT_STEPS, False, d, dev), name,
                            GIANT_STEPS // k)
            resumed = counted(f"ckpt resume, {driver}",
                              lambda: vg.ckpt(n, GIANT_STEPS, True, d, dev), name,
                              GIANT_STEPS // k)
        shutil.rmtree(d, ignore_errors=True)
        same_av = np.array_equal(resumed["av"].view(np.uint32),
                                 whole.av_vels.view(np.uint32))
        same_f = np.array_equal(np.asarray(resumed["f"]).view(np.uint32),
                                whole.f.view(np.uint32))
        print(f"validate_giant ckpt {n}^2, {driver} ({name}): fresh {GIANT_STEPS} steps "
              f"{fresh['elapsed_s']:.3f} s timed, {fresh['wall_s']:.3f} s wall; resume "
              f"steps_timed {resumed['steps_timed']}, {resumed['elapsed_s']:.3f} s timed, "
              f"{resumed['wall_s']:.3f} s wall; against an uninterrupted "
              f"{2 * GIANT_STEPS}-step run: av bitwise {same_av}, f bitwise {same_f}, "
              f"av[-1] {resumed['av_last']:.9e} | {card}", flush=True)
        require(fresh["ok"] and resumed["ok"], f"validate_giant ckpt ({driver}) failed")
        require(same_av and same_f,
                f"ckpt ({driver}): the resumed run differs from the uninterrupted one")
        rec["ckpt"][driver] = {key: v for key, v in resumed.items()
                               if key not in ("av", "f")}
        rec["ckpt"][driver]["fresh_wall_s"] = fresh["wall_s"]
    return rec


def _multi_kernel(ny: int, nx: int) -> str:
    """The multi-step kernel the route sends an ``ny x nx`` grid to on this
    card (``schedule.multi_route`` at the card's admitted cluster size and
    its SMs)."""
    import torch

    from lbm_tpu_torch.ops import schedule

    dev = torch.device("cuda", 0)
    route = schedule.multi_route(ny, nx, schedule.cluster_admission(dev)[0],
                                 schedule.bands_admission(dev))
    return LAUNCH_NAMES[route]


def _expected_launches(kind: str, args: tuple, steps: int, shape=None) -> dict:
    """The launches per kernel that ``steps`` steps of this schedule make:
    one per chunk (multi-step, of the kernel its route takes at ``shape``,
    ``(ny, nx)``), per K steps (x-tiled, temporal), per T*K steps (mega) or
    per step."""
    from lbm_tpu_torch.ops import fused

    name, per = {"multi": (_multi_kernel(*shape) if kind == "multi" else None,
                           lambda: args[0]),
                 "xtiled": ("lbm_temporal_xt_step", lambda: args[-1]),
                 "temporal": ("lbm_temporal_step", lambda: args[-1]),
                 "mega": ("lbm_mega_step", lambda: args[0] * args[1]),
                 "fused": ("lbm_fused_step", lambda: 1)}[kind]
    out = dict.fromkeys(fused.LAUNCHES, 0)
    out[name] = steps // per()
    return out


def _cli_run(label: str, argv: list, want: dict, rec: dict) -> str:
    """``lbm run`` through the port's CLI with every launch count set to 0
    just before and read just after; requires exit 0, ``want`` and the
    native I/O (NATIVE_PER_RUN)."""
    from lbm_tpu_torch import _native, cli
    from lbm_tpu_torch.ops import fused

    buf = io.StringIO()
    fused.reset_launches()
    _native.reset_calls()
    tic = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - tic
    launches = dict(fused.LAUNCHES)
    native = dict(_native.CALLS)
    out = buf.getvalue()
    print("  " + out.strip().replace("\n", "\n  "))
    require(rc == 0, f"{label}: cli run returned {rc}")
    require(launches == want, f"{label}: launches {launches}, expected {want}")
    require(native == NATIVE_PER_RUN, f"{label}: native I/O calls {native}, expected "
                                      f"{NATIVE_PER_RUN}: the run fell back to Python")
    for name, count in launches.items():
        rec["launches"][name] += count
    rec["cases"][label] = {"launches": launches, "wall_s": wall,
                           "elapsed_s": float(re.search(r"Elapsed time:\s+([0-9.]+)",
                                                        out).group(1))}
    return out


def _check_goldens(label: str, case: str, steps: int, d: pathlib.Path, full_fs: bool,
                   rec: dict) -> None:
    from lbm_tpu_torch.checker import check_files
    from lbm_tpu_torch.tools.check_self import golden_av_prefix

    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        res = check_files(
            ref_av_vels=str(golden_av_prefix(case, steps, d / "golden_av_vels.dat")),
            ref_final_state=(str(GOLDENS / f"{case}.fp64gen_final_state.dat")
                             if full_fs else None),
            av_vels=str(d / "av_vels.dat"),
            final_state=str(d / "final_state.dat") if full_fs else None,
        )
    print("  " + report.getvalue().strip().replace("\n", "\n  "))
    require(res.ok, f"{label}: checker failed against tests/goldens")
    rec["cases"][label]["worst_pct"] = {k: abs(v) for k, v in res.worst_pct.items()}


def _case_files(case: str, d: pathlib.Path) -> list:
    from lbm_tpu_torch.tools.gen_inputs import write_case

    return [str(p) for p in write_case(case, d)]


def phase_main(torch, card: str) -> dict:
    """The main path through the port's CLI: the four canonical cases and
    the one-step branch with the default kernel, ``--kernel mega`` on
    1024^2 x 20000, and a checkpointed 128^2 x 40000 run stopped at 20000
    steps and resumed, against an uninterrupted checkpointed run."""
    import shutil

    import numpy as np

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import canonical_obstacles, free_cells_of
    from lbm_tpu_torch.ops import fused, schedule
    from lbm_tpu_torch.runtime import make_program

    rec = {"cases": {}, "launches": dict.fromkeys(fused.LAUNCHES, 0)}
    runs = [(case, None) for case in CASES] + list(ONE_STEP_RUNS)
    for case, max_iters in runs:
        params = CANONICAL_PARAMS[case]
        steps = params.max_iters if max_iters is None else max_iters
        kind, args = schedule.choose_schedule(params.ny, params.nx, steps)
        want_kind = ("fused" if max_iters is not None
                     else "temporal" if case == "1024x1024" else "multi")
        require(kind == want_kind, f"{case} x {steps}: chooser took {kind}, "
                                   f"not {want_kind}")
        label = case if max_iters is None else f"{case}x{steps}"
        d = WORK / label
        argv = ["run", *_case_files(case, d), "--output-dir", str(d)]
        if max_iters is not None:
            argv += ["--max-iters", str(max_iters)]
        _cli_run(label, argv, _expected_launches(kind, args, steps, params.shape), rec)
        _check_goldens(label, case, steps, d, max_iters is None and case in
                       FINAL_STATE_GOLDENS, rec)
        c = rec["cases"][label]
        route = (_multi_kernel(*params.shape) if kind == "multi" else None)
        c.update(steps=steps, kernel=kind, schedule=list(args), multi_kernel=route,
                 mlups=params.nx * params.ny * steps / c["elapsed_s"] / 1e6)
        if route is not None:
            print(f"case {label}: the multi-step route takes {route} (cluster admission "
                  f"{list(schedule.cluster_admission(torch.device('cuda', 0)))})")
        print(f"case {label}: {steps} steps through {kind} {list(args)}, launches "
              f"{c['launches']}, {c['elapsed_s']:.6f} s timed ({c['wall_s']:.3f} s wall "
              f"incl. build check and writers), {c['mlups']:.1f} MLUPS, worst deviation "
              + ", ".join(f"{k} {v:.4f}%" for k, v in c["worst_pct"].items())
              + f" | {card}", flush=True)

    # --kernel mega: the megakernel's split of 1024^2 x 20000.
    case = "1024x1024"
    params = CANONICAL_PARAMS[case]
    obstacles = canonical_obstacles(case)
    mega = make_program(params, obstacles, np.float32(1.0) / np.float32(
        free_cells_of(obstacles)), "mega", torch.device("cpu"), max_iters=params.max_iters)
    require(isinstance(mega, fused.MegaStep), f"{case}: --kernel mega found no split")
    label = f"{case} --kernel mega"
    d = WORK / "1024x1024_mega"
    _cli_run(label, ["run", *_case_files(case, d), "--kernel", "mega", "--output-dir",
                     str(d)],
             _expected_launches("mega", (mega.tpasses, mega.ksteps), params.max_iters), rec)
    _check_goldens(label, case, params.max_iters, d, False, rec)
    c = rec["cases"][label]
    c.update(mega=[mega.by, mega.bx, mega.ksteps, mega.tpasses],
             mlups=params.nx * params.ny * params.max_iters / c["elapsed_s"] / 1e6)
    print(f"case {label}: tile {mega.by}x{mega.bx} K {mega.ksteps} T {mega.tpasses}, "
          f"launches {c['launches']}, {c['elapsed_s']:.6f} s timed, {c['mlups']:.1f} "
          f"MLUPS, worst deviation {c['worst_pct']} | {card}", flush=True)

    # Checkpointed: uninterrupted, then stopped at CKPT_STOP and resumed.
    case = CKPT_CASE
    params = CANONICAL_PARAMS[case]
    every = 10000  # the CLI's default --checkpoint-every
    seg_kind, seg_args = schedule.choose_schedule(params.ny, params.nx, every)
    root = WORK / "checkpointed"
    shutil.rmtree(root, ignore_errors=True)
    files = _case_files(case, root)
    for out, ckpt_dir, stop in (("whole", "a", None), ("stopped", "b", CKPT_STOP),
                                ("resumed", "b", None)):
        label = f"{case} checkpointed, {out}"
        argv = ["run", *files, "--checkpoint-dir", str(root / f"ckpt_{ckpt_dir}"),
                "--output-dir", str(root / out)]
        steps = params.max_iters - (CKPT_STOP if out == "resumed" else 0)
        if stop is not None:
            argv += ["--max-iters", str(stop)]
            steps = stop
        _cli_run(label, argv, _expected_launches(seg_kind, seg_args, steps, params.shape),
                 rec)
    whole, resumed = root / "whole", root / "resumed"
    for name in ("av_vels.dat", "final_state.dat"):
        require((whole / name).read_bytes() == (resumed / name).read_bytes(),
                f"checkpointed {case}: the resumed run's {name} differs from the "
                "uninterrupted run's")
    label = f"{case} checkpointed, resumed"
    _check_goldens(label, case, params.max_iters, resumed, True, rec)
    print(f"case {case} checkpointed every {every}: stopped at {CKPT_STOP}, resumed to "
          f"{params.max_iters}: av_vels.dat and final_state.dat byte-identical to the "
          f"uninterrupted checkpointed run; worst deviation "
          f"{rec['cases'][label]['worst_pct']} | {card}", flush=True)
    return rec


@contextlib.contextmanager
def _timing_expand(times: dict):
    """``runtime.expand_fields`` (which ``Simulator.run`` calls after its
    timer stops) timed into ``times["expand_fields"]`` inside the scope."""
    from lbm_tpu_torch import runtime

    expand = runtime.expand_fields

    def timed(*args):
        tic = time.perf_counter()
        out = expand(*args)
        times["expand_fields"] = time.perf_counter() - tic
        return out

    runtime.expand_fields = timed
    try:
        yield
    finally:
        runtime.expand_fields = expand


def phase_split(torch, card: str) -> dict:
    """Where the 1024^2 CLI run's wall time goes: the functions ``cli run``
    calls, each timed apart in this process after phase 4's warm CLI run
    (the library built, the kernels loaded): the parse, the library's load
    from its cached build, the Simulator and its program, the timed loop
    (``RunResult.elapsed``, which includes the fp16 payload's ``.cpu()``)
    and, inside it, the payload and its copy alone, ``expand_fields``
    after the timer, and both writers first in pure Python, then native,
    their files required byte-identical."""
    import numpy as np

    from lbm_tpu_torch import _native, geometry
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch import runtime
    from lbm_tpu_torch.config import LBMParams
    from lbm_tpu_torch.ops import _build

    case = "1024x1024"
    d = WORK / "split"
    files = _case_files(case, d)
    dev = torch.device("cuda", 0)
    t: dict = {}

    def timed(name, fn):
        tic = time.perf_counter()
        out = fn()
        t[name] = time.perf_counter() - tic
        return out

    _native.reset_calls()
    params = timed("params_from_file", lambda: LBMParams.from_file(files[0]))
    obstacles, _ = timed("parse_python", lambda: geometry.parse_obstacles_python(
        files[1], params.nx, params.ny))
    native_obstacles, _ = timed("parse_native", lambda: geometry.load_obstacle_file(
        files[1], params.nx, params.ny))
    require(_native.CALLS["parse_obstacles"] == 1, "the split's parse was not native")
    require(np.array_equal(obstacles, native_obstacles), "the native parser's mask differs")
    _build.load_library.cache_clear()
    timed("library_load", _build.load_library)
    sim = timed("simulator", lambda: runtime.Simulator(params, obstacles, device=dev))
    timed("program", lambda: sim.program)
    with _timing_expand(t):
        res = timed("run_wall", lambda: sim.run(readback="fields"))
    t["timed_loop"] = res.elapsed
    # The payload and its copy alone, from the run's final state on the card.
    state = sim.run(readback="device")
    fluid = sim.program.fluid.bool()
    for _ in range(2):  # the second reading, warm
        torch.cuda.synchronize()
        tic = time.perf_counter()
        sim._fields(state.f, fluid).cpu()
        t["fields_payload_and_copy"] = time.perf_counter() - tic
    del state
    fields64 = np.asarray(res.fields, dtype=np.float64)
    timed("write_final_state_python", lambda: lio.write_final_state_python(
        d / "final_state_python.dat", fields64, obstacles))
    timed("write_final_state_native", lambda: lio.write_final_state(
        d / "final_state_native.dat", params, None, obstacles, fields=res.fields))
    timed("write_av_vels_python", lambda: lio.write_av_vels_python(
        d / "av_vels_python.dat", res.av_vels))
    timed("write_av_vels_native", lambda: lio.write_av_vels(
        d / "av_vels_native.dat", res.av_vels))
    require(_native.CALLS["write_final_state"] == 1 and _native.CALLS["write_av_vels"] == 1,
            f"the split's writers were not native: {_native.CALLS}")
    same = {name: (d / f"{name}_python.dat").read_bytes()
            == (d / f"{name}_native.dat").read_bytes()
            for name in ("final_state", "av_vels")}
    for name, s in t.items():
        print(f"split {case} x {params.max_iters}: {name} {s:.6f} s | {card}", flush=True)
    print(f"split {case}: final_state.dat and av_vels.dat byte-identical, pure Python "
          f"against native: {same} | {card}", flush=True)
    require(all(same.values()), f"the native writers' files differ: {same}")
    return {"seconds": t, "byte_identical": same}


def phase_fp64(torch, card: str, rec: dict) -> dict:
    """1024^2's final_state.dat against the fp64 engine on the card, in this
    call: the fp64 engine's ms a step first (FP64_PROBE_STEPS), then the
    canonical CLI run's own file where the full run fits FP64_FULL_LIMIT_S,
    else a CLI run of FP64_CUT_STEPS steps, held at the checker's 1% and by
    the largest |du| relative to the fp64 run's largest |u|."""
    import numpy as np

    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch.checker import check_files
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import canonical_obstacles
    from lbm_tpu_torch.ops import schedule
    from lbm_tpu_torch.validation import run64

    case = "1024x1024"
    params, obstacles = CANONICAL_PARAMS[case], canonical_obstacles(case)
    dev = torch.device("cuda", 0)
    run64(params, obstacles, max_iters=10, device=dev)  # warm-up
    torch.cuda.synchronize()
    tic = time.perf_counter()
    run64(params, obstacles, max_iters=FP64_PROBE_STEPS, device=dev)  # av read back
    ms = (time.perf_counter() - tic) / FP64_PROBE_STEPS * 1e3
    full_s = ms * params.max_iters / 1e3
    if full_s <= FP64_FULL_LIMIT_S:
        steps, d = params.max_iters, WORK / case
        why = (f"the full {steps} fp64 steps take about {full_s:.1f} s <= "
               f"{FP64_FULL_LIMIT_S} s: the canonical CLI run's own file")
    else:
        steps, d = FP64_CUT_STEPS, WORK / f"{case}x{FP64_CUT_STEPS}_fp64"
        why = (f"the full {params.max_iters} fp64 steps would take about {full_s:.1f} s "
               f"> {FP64_FULL_LIMIT_S} s: a CLI run of {steps} steps")
        kind, args = schedule.choose_schedule(params.ny, params.nx, steps)
        _cli_run(f"{case}x{steps} (fp64 check)",
                 ["run", *_case_files(case, d), "--max-iters", str(steps),
                  "--output-dir", str(d)],
                 _expected_launches(kind, args, steps, params.shape), rec)
    print(f"fp64 engine at {case}: {ms:.4f} ms a step ({FP64_PROBE_STEPS} steps); {why} "
          f"| {card}", flush=True)
    tic = time.perf_counter()
    f64, av64 = run64(params, obstacles, max_iters=steps, device=dev)
    f64 = f64.cpu().numpy()
    seconds = time.perf_counter() - tic
    lio.write_final_state(d / "fp64_final_state.dat", params, f64, obstacles)
    lio.write_av_vels(d / "fp64_av_vels.dat", av64)
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        res = check_files(ref_av_vels=str(d / "fp64_av_vels.dat"),
                          ref_final_state=str(d / "fp64_final_state.dat"),
                          av_vels=str(d / "av_vels.dat"),
                          final_state=str(d / "final_state.dat"))
    print("  " + report.getvalue().strip().replace("\n", "\n  "))
    ours = lio.read_final_state(d / "final_state.dat")
    ref = np.stack([c.ravel() for c in lio.final_state_columns(params, f64, obstacles)[:3]],
                   axis=1)
    u_max = float(np.abs(ref[:, 2]).max())
    du = {name: float(np.abs(ours[:, 2 + i] - ref[:, i]).max() / u_max)
          for i, name in enumerate(("u_x", "u_y", "|u|"))}
    print(f"fp64 check at {case} x {steps}: {steps} fp64 steps in {seconds:.3f} s; checker "
          f"worst {res.worst_pct}; largest |du| over all cells relative to the fp64 run's "
          f"largest |u| ({u_max:.6e}): " + ", ".join(f"{k} {v:.3e}" for k, v in du.items())
          + f" | {card}", flush=True)
    require(res.ok, f"{case} x {steps}: final_state.dat fails the checker against fp64")
    require(all(v < FP64_DU_LIMIT for v in du.values()),
            f"{case} x {steps}: |du| {du} not under {FP64_DU_LIMIT} of the largest |u|")
    return {"steps": steps, "why": why, "ms_per_step": ms, "seconds": seconds,
            "worst_pct": {k: abs(v) for k, v in res.worst_pct.items()}, "du_rel": du}


def phase_gate(torch, card: str) -> dict:
    """``check_self`` on the four cases and ``bench_all --repeats 1``, each
    required to exit 0, their launches counted."""
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.tools import bench_all, check_self

    rec = {"launches": dict.fromkeys(fused.LAUNCHES, 0)}
    for label, main, argv in (
            ("check_self", check_self.main, ["--workdir", str(WORK / "check_self")]),
            ("bench_all --repeats 1 --markdown", bench_all.main,
             ["--repeats", "1", "--markdown"])):
        tic = time.perf_counter()
        rc, out, launches = _tool(label, main, argv)
        _add_launches(rec, launches)
        rec[label.split()[0]] = {"rc": rc, "seconds": time.perf_counter() - tic,
                                 "lines": out.strip().splitlines()}
        print(f"{label}: exit {rc} | {card}", flush=True)
        require(rc == 0, f"{label} exited {rc}")
    return rec


def phase_repro() -> None:
    import dataclasses

    import numpy as np

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import canonical_obstacles
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.runtime import Simulator

    for case, kind in (("1024x1024", fused.TemporalStep), ("128x128", fused.MultiStep),
                       ("256x256", fused.MultiStep)):
        params = dataclasses.replace(CANONICAL_PARAMS[case], max_iters=N_STEPS)
        sim = Simulator(params, canonical_obstacles(case), device="cuda:0")
        require(isinstance(sim.program, kind),
                f"{case} x {N_STEPS} runs {type(sim.program).__name__}")
        route = getattr(sim.program, "route", None)
        want = _multi_kernel(*params.shape) if kind is fused.MultiStep else None
        require(want is None or LAUNCH_NAMES[route] == want,
                f"{case} x {N_STEPS}: the multi-step route is {route}, not {want}'s")
        a, b = sim.run(readback="state"), sim.run(readback="state")
        same_av = np.array_equal(a.av_vels.view(np.uint32), b.av_vels.view(np.uint32))
        same_f = np.array_equal(a.f.view(np.uint32), b.f.view(np.uint32))
        print(f"{case} x {N_STEPS} through {kind.__name__}"
              + (f" (route {route})" if route else "") + f" twice: av_vels bitwise "
              f"equal {same_av}, f bitwise equal {same_f}")
        require(same_av and same_f, f"{case}: two identical runs differ")


def phase_debugging(torch, card: str) -> None:
    """The debugging scopes on the card: a 128^2 run inside
    ``interpret_kernels()`` launches no kernel, its f the kernel run's bits
    and its av within TOL_AV_CLUSTER (the multi-step kernel of its route
    against its plain version, as phase 3 holds it); ``nan_guard()``
    passes a healthy 1024^2 run and names launch 0 of a run whose first
    step divides 0 by 0."""
    import dataclasses

    import numpy as np

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import canonical_obstacles
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.ops.lattice import CX, CY
    from lbm_tpu_torch.runtime import Simulator
    from lbm_tpu_torch.utils.debugging import interpret_kernels, nan_guard

    params = dataclasses.replace(CANONICAL_PARAMS["128x128"], max_iters=200)
    sim = Simulator(params, canonical_obstacles("128x128"), device="cuda:0")
    kernel = sim.run(readback="state")
    fused.reset_launches()
    with interpret_kernels():
        plain = sim.run(readback="state")
    launched = sum(fused.LAUNCHES.values())
    same_f = np.array_equal(kernel.f.view(np.uint32), plain.f.view(np.uint32))
    av_rel = float(np.max(np.abs(kernel.av_vels - plain.av_vels) / np.abs(plain.av_vels)))
    print(f"interpret_kernels: 128x128 x 200 through {type(sim.program).__name__} (route "
          f"{sim.program.route}): {launched} kernel launches, f bitwise the kernel run's "
          f"{same_f}, av rel {av_rel:.3e} | {card}")
    require(launched == 0 and same_f and av_rel <= TOL_AV_CLUSTER,
            "interpret_kernels launched a kernel or moved f or av from the kernel run's")

    params = dataclasses.replace(CANONICAL_PARAMS["1024x1024"], max_iters=400)
    sim = Simulator(params, canonical_obstacles("1024x1024"), device="cuda:0")
    f0 = sim.initial_state().cpu().numpy()
    y, x = 500, 500
    for k in range(9):
        f0[k, y - CY[k], x - CX[k]] = 0.0
    with nan_guard():
        healthy = sim.run(readback="state")
        try:
            sim.run(f0=f0, readback="state")
            caught = None
        except FloatingPointError as e:
            caught = str(e)
    print(f"nan_guard: 1024x1024 x 400 healthy run passed (av[-1] {healthy.av_vels[-1]:.9e}); "
          f"with rho 0 at ({y}, {x}): {caught!r} | {card}")
    require(caught is not None and "launch 0 " in caught,
            f"nan_guard did not stop the poisoned run at launch 0: {caught!r}")


def _mesh(py, px):
    from lbm_tpu_torch.parallel.mesh import default_mesh, default_mesh_2d

    return default_mesh(py) if px is None else default_mesh_2d(py, px)


def _mesh_name(py, px) -> str:
    return f"{py} rows" if px is None else f"{py}x{px}"


def _shard_factories(py, px):
    """(one-step factory, temporal factory) of a 1-D or 2-D mesh."""
    from lbm_tpu_torch.parallel import sharded

    if px is None:
        return sharded.make_sharded_fused_run, sharded.make_sharded_temporal_run
    return sharded.make_sharded_fused_2d_run, sharded.make_sharded_temporal_2d_run


def _run_sharded(program, f0, launches, plain=False):
    """``launches`` launches of a sharded program from the global ``f0``,
    each launch its halo exchange and every shard's kernel (or plain
    version): (f on the host, av of those steps on the host)."""
    state, av = program.run(f0, launches, plain=plain)
    return state.cpu(), av.cpu()


def _hold_shard(name, label, prog, f0, steps, rec, key):
    """A sharded program's kernel against its plain version, through whole
    sharded runs from ``f0``: after one launch and after ``steps`` steps,
    f bitwise and av within TOL_AV_INPLACE; the kernel's launches counted.
    The errors go into ``rec[name]`` under ``key``."""
    import torch

    from lbm_tpu_torch.ops import fused

    launches = steps // prog.chunk
    before = fused.LAUNCHES[name]
    k1, kav1 = _run_sharded(prog, f0, 1)
    kn, kavn = _run_sharded(prog, f0, launches)
    torch.cuda.synchronize()
    launched = fused.LAUNCHES[name] - before
    p1, pav1 = _run_sharded(prog, f0, 1, plain=True)
    pn, pavn = _run_sharded(prog, f0, launches, plain=True)
    r = rec[name]
    errs = [_check_inplace(f"{label} 1 launch", k1, kav1, p1, pav1, r),
            _check_inplace(f"{label} {steps} steps", kn, kavn, pn, pavn, r, "_1000")]
    require(launched == (1 + launches) * prog.mesh.size,
            f"{label}: launch count {launched}")
    r["by_shape"][key] = errs
    print(f"{label}: max|df| and av rel against its plain version, 1 launch "
          f"{errs[0]}, {steps} steps {errs[1]}; launches +{launched}", flush=True)


def _shard_kernel_name(prog) -> str:
    return "lbm_shard_temporal_step" if prog.variant == "temporal" else "lbm_shard_step"


def _tile_name(prog) -> str:
    first = prog.shards[0][0]
    return (f"{prog.layout.nyl}x{prog.layout.nxl}"
            + (f", tiles {first.by}x{first.bx}, K {first.chunk}"
               if prog.variant == "temporal" else ""))


def phase_sharded_kernels(torch, card: str, seed0: int) -> dict:
    """Each shard kernel against its plain version, through whole sharded
    runs (the halo exchange included): f bitwise and av within
    TOL_AV_INPLACE relative, after one launch and after N_STEPS steps (to a
    whole number of passes), at SHARD_SHAPES, 1-D and 2-D halos, and at
    the programs the sharded CLI runs of phase 7 take (SHARD_CLI: the
    canonical grid and mesh, routed as the CLI routes them)."""
    import dataclasses

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import canonical_obstacles
    from lbm_tpu_torch.parallel.sharded import ShardedSimulator

    dev = torch.device("cuda", 0)
    recs = {name: {"max_abs_err": 0.0, "max_av_rtol": 0.0, "max_abs_err_1000": 0.0,
                   "max_av_rtol_1000": 0.0, "by_shape": {}}
            for name in ("lbm_shard_step", "lbm_shard_temporal_step")}
    for seed, (ny, nx, py, px, by, k) in enumerate(SHARD_SHAPES, start=seed0):
        params, obstacles, fcinv, f0 = _setup(ny, nx, seed, dev, torch)
        steps = -(-N_STEPS // k) * k
        params = dataclasses.replace(params, max_iters=steps)
        mesh = _mesh(py, px)
        one, temporal = _shard_factories(py, px)
        for prog in (one(params, obstacles, fcinv, mesh),
                     temporal(params, obstacles, fcinv, mesh, by=by, ksteps=k)):
            name = _shard_kernel_name(prog)
            label = f"{name} {nx}x{ny} over {_mesh_name(py, px)} ({_tile_name(prog)})"
            _hold_shard(name, label, prog, f0, steps, recs,
                        f"{nx}x{ny}/{_mesh_name(py, px)}")
    for seed, (case, py, px) in enumerate(SHARD_CLI, start=seed0 + len(SHARD_SHAPES)):
        params = CANONICAL_PARAMS[case]
        prog = ShardedSimulator(params, canonical_obstacles(case),
                                mesh=_mesh(py, px)).compiled()
        f0 = _setup(params.ny, params.nx, seed, dev, torch)[3]
        name = _shard_kernel_name(prog)
        label = (f"{name} {case} over {_mesh_name(py, px)} as the CLI runs it "
                 f"({_tile_name(prog)})")
        _hold_shard(name, label, prog, f0, -(-N_STEPS // prog.chunk) * prog.chunk, recs,
                    f"{case}/{_mesh_name(py, px)} (CLI)")
    return recs


def phase_sharded_equality(torch, card: str, seed: int) -> dict:
    """Sharded runs at 1024^2 x SHARD_EQ_STEPS against the single-device
    kernel run from the same seeded state: f bitwise, av within
    SHARD_AV_RTOL, over SHARD_MESHES, the one-step and temporal kernels."""
    import dataclasses

    import numpy as np

    from lbm_tpu_torch.runtime import Simulator

    dev = torch.device("cuda", 0)
    params, obstacles, fcinv, f0 = _setup(1024, 1024, seed, dev, torch)
    params = dataclasses.replace(params, max_iters=SHARD_EQ_STEPS)
    sim = Simulator(params, obstacles, device=dev)
    single = sim.run(f0=f0, readback="state")
    rec = {"single_program": type(sim.program).__name__, "runs": {}}
    for py, px in SHARD_MESHES:
        mesh = _mesh(py, px)
        one, temporal = _shard_factories(py, px)
        for variant, prog in (("fused", one(params, obstacles, fcinv, mesh)),
                              ("temporal", temporal(params, obstacles, fcinv, mesh))):
            require(prog is not None and prog.variant == variant,
                    f"{_mesh_name(py, px)} {variant}: no program")
            f, av = _run_sharded(prog, f0, SHARD_EQ_STEPS // prog.chunk)
            same = np.array_equal(f.numpy().view(np.uint32), single.f.view(np.uint32))
            av_rel = float(np.max(np.abs(av.numpy() - single.av_vels)
                                  / np.abs(single.av_vels)))
            label = f"1024x1024 x {SHARD_EQ_STEPS} over {_mesh_name(py, px)}, {variant}"
            print(f"{label} (chunk {prog.chunk}): f bitwise equal to the single-device "
                  f"{rec['single_program']} run {same}, av rel {av_rel:.3e}", flush=True)
            require(same, f"{label}: f differs from the single-device run")
            require(av_rel <= SHARD_AV_RTOL, f"{label}: av rel {av_rel} > {SHARD_AV_RTOL}")
            rec["runs"][f"{_mesh_name(py, px)}/{variant}"] = {"f_bitwise": same,
                                                              "av_rel": av_rel}
    return rec


def _is_copy(key: str) -> bool:
    return "copy" in key.lower() or "memcpy" in key.lower()


def phase_sharded_big(torch, card: str) -> dict:
    """The weak-scaling grid (BASELINE.json configs[4], 4096^2) on one card,
    in turns (A, B, C, D, D, C, B, A): A the single-device run, B 8 row
    shards, C a 4x2 mesh (both with "fused", the default on CUDA: temporal
    on the row mesh, one-step on the 2-D one), D the 4x2 mesh with the
    temporal kernel;
    each ``run(readback="device")`` of SHARD_BIG_STEPS steps, its launches
    counted, its f gathered after the timer and held against the first
    single-device run's (f bitwise, av within SHARD_AV_RTOL).  Then, per
    sharded run, the profiler's device time by kernel and the halo copies'
    share of it; each shard kernel against its plain version on the 4096^2
    tiles (one launch from run A's f, every shard); each kernel alone
    (every shard's launches, no exchange) by CUDA events; the plain
    versions."""
    import numpy as np

    from lbm_tpu_torch.config import LBMParams
    from lbm_tpu_torch.geometry import channel_box, free_cells_of
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.parallel.sharded import ShardedSimulator
    from lbm_tpu_torch.runtime import Simulator

    dev = torch.device("cuda", 0)
    n = SHARD_BIG
    # lbm_tpu's tools/bench_sharded.py case: the canonical physics in a
    # closed channel box.
    params = LBMParams(n, n, SHARD_BIG_STEPS, 10, 0.1, 0.005, 1.85)
    obstacles = channel_box(n, n)
    fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
    sims = {
        "A single device": Simulator(params, obstacles, device=dev),
        "B 8 row shards": ShardedSimulator(params, obstacles, mesh=_mesh(8, None),
                                           kernel="fused"),
        "C 4x2": ShardedSimulator(params, obstacles, mesh=_mesh(4, 2), kernel="fused"),
        "D 4x2 temporal": ShardedSimulator(params, obstacles, mesh=_mesh(4, 2),
                                           kernel="temporal"),
    }
    rec = {"runs": {}, "launches": dict.fromkeys(fused.LAUNCHES, 0)}
    for name, sim in sims.items():
        prog = sim.program if name.startswith("A") else sim.compiled()
        rec["runs"][name] = {"elapsed_s": [], "program": type(prog).__name__,
                             "chunk": prog.chunk,
                             "variant": getattr(prog, "variant", None)}
        sim.run(max_iters=prog.chunk * 4, readback="device")  # warm-up
    torch.cuda.synchronize()
    names = list(sims)
    ref = None  # the first single-device run's (f, av) on the host
    for name in names + names[::-1]:
        fused.reset_launches()
        res = sims[name].run(readback="device")
        launches = dict(fused.LAUNCHES)
        require(bool(np.isfinite(res.av_vels).all()), f"{name}: non-finite av")
        r = rec["runs"][name]
        r["elapsed_s"].append(res.elapsed)
        r["launches"] = launches
        for kname, count in launches.items():
            rec["launches"][kname] += count
        # After the timer: f gathered on the host, against run A's (the
        # first run), f bitwise and av within SHARD_AV_RTOL.
        f, av = res.f.cpu(), res.av_vels
        del res
        if ref is None:
            ref = (f, av)
        same = torch.equal(f.view(torch.int32), ref[0].view(torch.int32))
        av_rel = float(np.max(np.abs(av - ref[1]) / np.abs(ref[1])))
        require(same, f"{n}x{n} {name}: f differs from the single-device run's")
        require(av_rel <= SHARD_AV_RTOL,
                f"{n}x{n} {name}: av rel {av_rel} > {SHARD_AV_RTOL} against the "
                "single-device run")
        r["f_bitwise_single"] = same
        r["av_rel_single"] = max(r.get("av_rel_single", 0.0), av_rel)
        del f
    for name, r in rec["runs"].items():
        mean = sum(r["elapsed_s"]) / len(r["elapsed_s"])
        r["us_per_step"] = mean / SHARD_BIG_STEPS * 1e6
        r["mlups"] = n * n * SHARD_BIG_STEPS / mean / 1e6
        print(f"{n}x{n} x {SHARD_BIG_STEPS} {name} ({r['program']}, {r['variant']}, "
              f"{r['chunk']} steps a launch): {r['us_per_step']:.3f} us/step, "
              f"{r['mlups']:.1f} MLUPS, turns {[round(e, 6) for e in r['elapsed_s']]} s, "
              f"launches {r['launches']} | {card}", flush=True)

    # Device time by kernel over a window of each sharded run, and the halo
    # copies' share of it.
    from torch.profiler import ProfilerActivity, profile

    window = SHARD_PROFILE_STEPS
    for name in names[1:]:
        sim = sims[name]
        sim.run(max_iters=window, readback="device")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = sim.run(max_iters=window, readback="device")
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        total = sum(e.self_device_time_total for e in events)
        copies = sum(e.self_device_time_total for e in events if _is_copy(e.key))
        # The shard kernel and its av reduction: the wrapper's two launches.
        own = sum(e.self_device_time_total for e in events
                  if "lbm_shard" in e.key or "av_reduce" in e.key)
        r = rec["runs"][name]
        r["profile"] = {
            "device_us_per_step": total / window if total else None,
            "kernel_us_per_step": own / window if total else None,
            "halo_copy_us_per_step": copies / window if total else None,
            "halo_copy_share": copies / total if total else None,
            "wall_us_per_step": res.elapsed / window * 1e6,
            "by_kernel_us_per_step": {e.key[:60]: e.self_device_time_total / window
                                      for e in events},
            "calls": {e.key[:60]: e.count for e in events},
        }
        print(f"{n}x{n} {name}, profiler over {window} steps: device "
              f"{r['profile']['device_us_per_step']} us/step of "
              f"{r['profile']['wall_us_per_step']:.2f} us wall, halo copies "
              f"{r['profile']['halo_copy_us_per_step']} us/step (share "
              f"{r['profile']['halo_copy_share']}), by kernel "
              f"{r['profile']['by_kernel_us_per_step']} | {card}", flush=True)
        del res

    # Each shard kernel at the main path's shapes: one launch of the
    # program (the exchange, then every shard's kernel) from run A's final
    # f, each shard's output held against its plain version on the same
    # padded input (f bitwise, its sums within TOL_AV_INPLACE).  Then each
    # kernel alone: every shard's launches, no exchange, by CUDA events;
    # the plain versions on the same buffers.
    kernels = {}
    for kname, name in (("lbm_shard_temporal_step", "B 8 row shards"),
                        ("lbm_shard_step", "C 4x2")):
        prog = sims[name].compiled()
        lay = prog.layout
        errs = {"max_abs_err": 0.0, "max_av_rtol": 0.0}
        with torch.cuda.device(dev):
            bufs, sums = prog.alloc()
            prog.upload(bufs, ref[0])
            launch = prog.bind(bufs, sums)
            launch(0)  # b[0]'s halos exchanged, every shard: b[0] -> b[1]
            shards = [(p, b, s) for row, brow, srow in zip(prog.shards, bufs, sums)
                      for p, b, s in zip(row, brow, srow)]
            for iy, (p, b, s) in enumerate(shards):
                pf, ps = p.plain_launch(b[0])
                _check_inplace(f"{n}x{n} {kname} over {name}, shard {iy}, 1 launch",
                               lay.interior(b[1]), s[:prog.chunk], pf, ps, errs)
                del pf, ps
            launch(1)  # b[1]'s halos too, for the timed loop
            calls = [p.bind(b[0], b[1], s) for p, b, s in shards]
            cap = SHARD_BIG_STEPS // prog.chunk
            state = {"i": 0}

            def run(steps, calls=calls, cap=cap, prog=prog, state=state):
                for _ in range(steps // prog.chunk):
                    for fn in calls:
                        fn(state["i"] % cap)
                    state["i"] += 1

            ms = [_ms_per_step(run, 400, torch, 8 * prog.chunk) for _ in range(2)]
            plain_calls = [(p, b[0]) for p, b, _ in shards]

            def plain(steps, plain_calls=plain_calls, prog=prog):
                for _ in range(steps // prog.chunk):
                    for p, f in plain_calls:
                        p.plain_launch(f)

            plain_ms = [_ms_per_step(plain, prog.chunk, torch, prog.chunk)
                        for _ in range(2)]
        print(f"{n}x{n} {kname} over {name} (tile {lay.nyl}x{lay.nxl}), one launch from "
              f"run A's f against its plain version, every shard: max|df| "
              f"{errs['max_abs_err']}, sums rel {errs['max_av_rtol']}", flush=True)
        first = prog.shards[0][0]
        halo_cells = lay.rows * (lay.nxl + 2 * lay.halo)
        kernels[kname] = {
            "errs": errs, "ms_runs": ms, "plain_ms_runs": plain_ms, "mesh": name,
            "tile": [lay.nyl, lay.nxl], "halo": lay.halo,
            "temporal_tile": ([first.by, first.bx] if kname == "lbm_shard_temporal_step"
                              else None),
            "chunk": prog.chunk, "shards": prog.mesh.size,
            # The function's bytes a step: each shard reads its tile with its
            # halo once (9 fp32 and the mask byte a cell) and writes its
            # owned cells once, per launch of `chunk` steps.
            "bytes_per_step": prog.mesh.size * (halo_cells * 37 + lay.nyl * lay.nxl * 36)
                              / prog.chunk,
            "device_us": rec["runs"][name]["profile"]["kernel_us_per_step"],
        }
        print(f"{n}x{n} {kname} alone over {name} (tile {lay.nyl}x{lay.nxl}, halo "
              f"{lay.halo}): {[round(m * 1e3, 3) for m in ms]} us/step by CUDA events; "
              f"plain {[round(m * 1e3, 1) for m in plain_ms]} us/step | {card}",
              flush=True)
        del bufs, sums, shards, calls, plain_calls
        torch.cuda.empty_cache()
    rec["kernels"] = kernels
    return rec


def _against_single(label: str, single: pathlib.Path, d: pathlib.Path, rec: dict) -> None:
    """A sharded CLI run's files against the single-device CLI run's of the
    same case from phase 4: final_state.dat byte-identical (f bitwise, the
    fields computed alike), av_vels.dat within SHARD_AV_RTOL relative."""
    import numpy as np

    from lbm_tpu_torch.io import read_av_vels

    same = (single / "final_state.dat").read_bytes() == (d / "final_state.dat").read_bytes()
    ref, av = read_av_vels(single / "av_vels.dat"), read_av_vels(d / "av_vels.dat")
    require(ref.shape == av.shape, f"{label}: {av.shape} av_vels rows, single-device "
                                   f"{ref.shape}")
    av_rel = float(np.max(np.abs(av - ref) / np.abs(ref)))
    print(f"  {label} against the single-device CLI run: final_state.dat byte-identical "
          f"{same}, av_vels rel {av_rel:.3e}", flush=True)
    require(same, f"{label}: final_state.dat differs from the single-device run's")
    require(av_rel <= SHARD_AV_RTOL, f"{label}: av_vels rel {av_rel} > {SHARD_AV_RTOL} "
                                     "against the single-device run")
    rec["cases"][label].update(final_state_as_single=same, av_rel_single=av_rel)


def phase_sharded_cli(torch, card: str) -> dict:
    """The sharded main path through the CLI: ``--shards 4`` on 128^2 x
    40000 and ``--mesh 2x2`` on 128x256 x 40000 against tests/goldens at
    1%; ``--shards 4`` on 128^2 x 40000 checkpointed, uninterrupted and
    stopped at CKPT_STOP and resumed, the two runs' files byte-identical.
    Every launch count is set to 0 just before each run and read after."""
    import shutil

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.parallel.sharded import ShardedSimulator
    from lbm_tpu_torch.geometry import canonical_obstacles

    rec = {"cases": {}, "launches": dict.fromkeys(fused.LAUNCHES, 0)}

    def want(case, flags, steps):
        params = CANONICAL_PARAMS[case]
        mesh = _mesh(4, None) if flags[0] == "--shards" else _mesh(2, 2)
        prog = ShardedSimulator(params, canonical_obstacles(case), mesh=mesh).compiled(
            steps)
        out = dict.fromkeys(fused.LAUNCHES, 0)
        out["lbm_shard_temporal_step" if prog.variant == "temporal"
            else "lbm_shard_step"] = steps // prog.chunk * mesh.size
        return out, prog

    for case, flags in (("128x128", ["--shards", "4"]), ("128x256", ["--mesh", "2x2"])):
        params = CANONICAL_PARAMS[case]
        label = f"{case} {' '.join(flags)}"
        d = WORK / f"sharded_{case}"
        launches, prog = want(case, flags, params.max_iters)
        _cli_run(label, ["run", *_case_files(case, d), *flags, "--output-dir", str(d)],
                 launches, rec)
        _check_goldens(label, case, params.max_iters, d, case in FINAL_STATE_GOLDENS,
                       rec)
        _against_single(label, WORK / case, d, rec)
        c = rec["cases"][label]
        c.update(variant=prog.variant, chunk=prog.chunk,
                 mlups=params.nx * params.ny * params.max_iters / c["elapsed_s"] / 1e6)
        print(f"case {label}: {prog.variant}, {prog.chunk} steps a launch, launches "
              f"{c['launches']}, {c['elapsed_s']:.6f} s timed ({c['wall_s']:.3f} s wall), "
              f"{c['mlups']:.1f} MLUPS, worst deviation "
              + ", ".join(f"{k} {v:.4f}%" for k, v in c["worst_pct"].items())
              + f" | {card}", flush=True)

    case, flags = CKPT_CASE, ["--shards", "4"]
    params = CANONICAL_PARAMS[case]
    every = 10000
    root = WORK / "sharded_checkpointed"
    shutil.rmtree(root, ignore_errors=True)
    files = _case_files(case, root)
    for out, ckpt_dir, stop in (("whole", "a", None), ("stopped", "b", CKPT_STOP),
                                ("resumed", "b", None)):
        label = f"{case} {' '.join(flags)} checkpointed, {out}"
        argv = ["run", *files, *flags, "--checkpoint-dir", str(root / f"ckpt_{ckpt_dir}"),
                "--output-dir", str(root / out)]
        steps = params.max_iters - (CKPT_STOP if out == "resumed" else 0)
        if stop is not None:
            argv += ["--max-iters", str(stop)]
            steps = stop
        launches, _ = want(case, flags, every)
        launches = {k: v * steps // every for k, v in launches.items()}
        _cli_run(label, argv, launches, rec)
    whole, resumed = root / "whole", root / "resumed"
    for name in ("av_vels.dat", "final_state.dat"):
        require((whole / name).read_bytes() == (resumed / name).read_bytes(),
                f"sharded checkpointed {case}: the resumed run's {name} differs from "
                "the uninterrupted run's")
    label = f"{case} {' '.join(flags)} checkpointed, resumed"
    _check_goldens(label, case, params.max_iters, resumed, True, rec)
    _against_single(label, WORK / "checkpointed" / "whole", resumed, rec)
    print(f"case {case} {' '.join(flags)} checkpointed every {every}: stopped at "
          f"{CKPT_STOP}, resumed to {params.max_iters}: av_vels.dat and final_state.dat "
          f"byte-identical to the uninterrupted run; worst deviation "
          f"{rec['cases'][label]['worst_pct']} | {card}", flush=True)
    return rec


def _kernel_resources(path: pathlib.Path) -> dict:
    """``cuobjdump --dump-resource-usage`` of the library at ``path``:
    {kernel name: its usage line ("REG:.. STACK:.. SHARED:.. LOCAL:..
    CONSTANT[0]:.. ...")} for the kernels of RESOURCE_KERNELS, matched by
    name inside the mangled symbol."""
    from lbm_tpu_torch.ops import _build

    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(path)],
                         capture_output=True, text=True, check=True, timeout=120).stdout
    lines = out.splitlines()
    found = {}
    for i, line in enumerate(lines[:-1]):
        if "Function" not in line:
            continue
        for name in RESOURCE_KERNELS:
            if re.search(rf"\d{name}\w*:", line):
                found[name] = lines[i + 1].strip()
        for label, part in PRINTED_KERNELS.items():
            if part in line:
                found[label] = lines[i + 1].strip()
    return found


def phase_shard_xt_kernels(torch, card: str, seed0: int) -> dict:
    """The shard x-tiled kernel against its plain version (the band
    algorithm in torch on the slab and its ghost rows), through whole
    sharded runs (the ghost exchange included): f bitwise and av within
    TOL_AV_INPLACE relative, after one launch and after N_STEPS steps (to a
    whole number of passes), at XT_SHARD_SHAPES, at XT_SHARD_PREFETCH (at
    least three tiles a block of its persistent grid; there f also bitwise
    K and N_STEPS plain one-steps of the whole grid) and at the program the
    CLI's ``--shards 4 --temporal-split 32x4x2`` on 1024^2 runs (phase
    8c), built as the CLI builds it.  Each shard program's grid is
    printed."""
    import dataclasses

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.geometry import canonical_obstacles
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.parallel import sharded

    dev = torch.device("cuda", 0)
    name = "lbm_shard_temporal_xt_step"
    recs = {name: {"max_abs_err": 0.0, "max_av_rtol": 0.0, "max_abs_err_1000": 0.0,
                   "max_av_rtol_1000": 0.0, "by_shape": {}}}
    for seed, (ny, nx, py, by, k, px) in enumerate(XT_SHARD_SHAPES, start=seed0):
        params, obstacles, fcinv, f0 = _setup(ny, nx, seed, dev, torch)
        steps = -(-N_STEPS // k) * k
        params = dataclasses.replace(params, max_iters=steps)
        prog = sharded.make_sharded_temporal_xt_run(params, obstacles, fcinv, _mesh(py, None),
                                                    by=by, ksteps=k, px=px)
        first = prog.shards[0][0]
        label = (f"{name} {nx}x{ny} over {py} rows ({prog.layout.nyl}x{nx} slabs, tiles "
                 f"{first.by}x{first.bx}, K {k}, PX {px})")
        _hold_shard(name, label, prog, f0, steps, recs, f"{nx}x{ny}/{py} rows/BY{by}/K{k}")
    seed = seed0 + len(XT_SHARD_SHAPES)
    for seed, (ny, nx, py, by, bx, k) in enumerate(XT_SHARD_PREFETCH, start=seed):
        params, obstacles, fcinv, f0 = _setup(ny, nx, seed, dev, torch)
        steps = -(-N_STEPS // k) * k
        params = dataclasses.replace(params, max_iters=steps)
        # The factory's own constructor, with BX given (px would cap it at
        # half the width).
        prog = sharded._xt_program(params, obstacles, fcinv, _mesh(py, None), steps, by,
                                   bx, k)
        for p in (p for row in prog.shards for p in row):
            require(p.tiles[0] * p.tiles[1] >= PREFETCH_TILES_A_BLOCK * p.nblocks,
                    f"{name} {nx}x{ny}: {_grid_text(p)}, fewer than "
                    f"{PREFETCH_TILES_A_BLOCK} tiles a block")
        label = (f"{name} {nx}x{ny} over {py} rows ({prog.layout.nyl}x{nx} slabs, tiles "
                 f"{by}x{bx}, K {k}; grid {_grid_text(prog.shards[0][0])} a shard)")
        key = f"{nx}x{ny}/{py} rows/{by}x{bx}/K{k}"
        _hold_shard(name, label, prog, f0, steps, recs, key)
        one = fused.FusedStep(params, obstacles, fcinv, dev)
        r = recs[name]
        for launches in (1, steps // k):
            kf, kav = _run_sharded(prog, f0, launches)
            sf, sav = _run_plain_steps(one, f0, launches * k, torch)
            errs = _check_inplace(f"{label} vs {launches * k} plain one-steps", kf.to(dev),
                                  kav.to(dev), sf, sav, r, "" if launches == 1 else "_1000")
            r["by_shape"][key] += errs
            print(f"{label}: against {launches * k} plain one-steps of the grid: max|df| "
                  f"{errs[0]}, av rel {errs[1]}")
            del kf, sf
    case, py, split = XT_SHARD_CLI
    params = CANONICAL_PARAMS[case]
    prog = sharded.ShardedSimulator(params, canonical_obstacles(case), mesh=_mesh(py, None),
                                    temporal_split=split).compiled()
    f0 = _setup(params.ny, params.nx, seed0 + len(XT_SHARD_SHAPES) + len(XT_SHARD_PREFETCH),
                dev, torch)[3]
    first = prog.shards[0][0]
    require(isinstance(first, fused.ShardTemporalXtStep),
            f"{case} over {py} rows, split {split}: routed to {type(first).__name__}")
    label = (f"{name} {case} over {py} rows as the CLI runs it ({prog.layout.nyl}x"
             f"{params.nx} slabs, tiles {first.by}x{first.bx}, K {first.ksteps})")
    _hold_shard(name, label, prog, f0, -(-N_STEPS // prog.chunk) * prog.chunk, recs,
                f"{case}/{py} rows (CLI)")
    return recs


def _sharded_loop(prog, f0, torch):
    """``run(steps)`` over one bound state of a sharded program (its
    exchange and every shard's launch, whole launches, the sums cycling
    over the run's slots): times the launches alone."""
    with torch.cuda.device(prog.device0):
        bufs, sums = prog.alloc()
        prog.upload(bufs, f0)
        launch = prog.bind(bufs, sums)
    cap = prog.max_iters // prog.chunk
    state = {"i": 0}

    def run(steps):
        for _ in range(steps // prog.chunk):
            launch(state["i"] % cap)
            state["i"] += 1

    return run


def phase_shard_xt_big(torch, card: str) -> dict:
    """The sharded x-tiled route at 8192^2 x GIANT_STEPS over 2 and 4 row
    shards and a (2, 1) mesh, with the device budget at 0 (as on a card
    that does not hold the shards' ping-pong tiles), so the routing takes
    it: each ``run(readback="device")`` with its launches counted, its f
    bitwise the single-device x-tiled run's and its av within
    SHARD_AV_RTOL; then the shard kernel against its plain version on the
    8192^2 slabs (one launch from that run's f, every shard); the time per
    step by CUDA events in turns (A single device, B 2 rows, C 4 rows,
    D (2, 1), then back); the ghost copies' share of device time; the peak
    device memory of each run against f."""
    import numpy as np

    from lbm_tpu_torch.geometry import free_cells_of
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.ops.reference import init_cells
    from lbm_tpu_torch.parallel.sharded import ShardedSimulator
    from lbm_tpu_torch.runtime import Simulator
    from lbm_tpu_torch.tools import validate_giant

    dev = torch.device("cuda", 0)
    n, steps = GIANT_SIZES[0], GIANT_STEPS
    params, obstacles = validate_giant.setup(n, steps)
    f_bytes = 9 * n * n * 4
    rec = {"runs": {}, "launches": dict.fromkeys(fused.LAUNCHES, 0), "f_bytes": f_bytes}
    name = "lbm_shard_temporal_xt_step"
    with _no_room_for_pingpong():
        single = Simulator(params, obstacles, device=dev)
        require(isinstance(single.program, fused.TemporalXtStep),
                f"{n}x{n}: the single-device run took {type(single.program).__name__}")
        sims = {"B 2 rows": ShardedSimulator(params, obstacles, mesh=_mesh(2, None),
                                             kernel="fused"),
                "C 4 rows": ShardedSimulator(params, obstacles, mesh=_mesh(4, None),
                                             kernel="fused"),
                "D 2x1": ShardedSimulator(params, obstacles, mesh=_mesh(2, 1),
                                          kernel="temporal")}
        progs = {key: sim.compiled() for key, sim in sims.items()}
    for key, prog in progs.items():
        first = prog.shards[0][0]
        require(isinstance(first, fused.ShardTemporalXtStep),
                f"{n}x{n} {key}: routed to {type(first).__name__}, not the x-tiled route")
    ref = single.run(readback="state")
    ref_f = torch.from_numpy(ref.f)
    print(f"{n}x{n} x {steps} single device ({type(single.program).__name__}, tile "
          f"{single.program.by}x{single.program.bx}, K {single.program.ksteps}): "
          f"{ref.elapsed:.6f} s", flush=True)
    for key, sim in sims.items():
        prog = progs[key]
        first = prog.shards[0][0]
        fused.reset_launches()
        res = sim.run(readback="device")
        launches = dict(fused.LAUNCHES)
        for kname, count in launches.items():
            rec["launches"][kname] += count
        want = steps // prog.chunk * prog.mesh.size
        require(launches[name] == want and sum(launches.values()) == want,
                f"{n}x{n} {key}: launches {launches}, expected {want} of {name}")
        f = res.f.cpu()
        same = torch.equal(f.view(torch.int32), ref_f.view(torch.int32))
        av_rel = float(np.max(np.abs(res.av_vels - ref.av_vels) / np.abs(ref.av_vels)))
        print(f"{n}x{n} x {steps} {key} ({prog.layout.nyl}x{n} slabs, tiles "
              f"{first.by}x{first.bx}, K {first.ksteps}): {res.elapsed:.6f} s, launches "
              f"{launches}; f bitwise equal to the single-device x-tiled run {same}, av rel "
              f"{av_rel:.3e}", flush=True)
        require(same, f"{n}x{n} {key}: f differs from the single-device x-tiled run's")
        require(av_rel <= SHARD_AV_RTOL, f"{n}x{n} {key}: av rel {av_rel} > {SHARD_AV_RTOL}")
        rec["runs"][key] = {"elapsed_s": res.elapsed, "launches": launches,
                            "f_bitwise_single": same, "av_rel_single": av_rel,
                            "slab": [prog.layout.nyl, n], "tile": [first.by, first.bx],
                            "k": first.ksteps, "shards": prog.mesh.size,
                            "band_floats": sum(p.band_floats for row in prog.shards
                                               for p in row)}
        del res, f

    # One launch on the 8192^2 slabs from the run's final f, every shard,
    # against the plain version on the same f and the ghost rows the
    # exchange filled.
    errs = {"max_abs_err": 0.0, "max_av_rtol": 0.0}
    for key in ("B 2 rows", "C 4 rows"):
        prog = progs[key]
        bufs, sums = prog.alloc()
        prog.upload(bufs, ref_f)
        launch = prog.bind(bufs, sums)
        before = [b[0].clone() for row in bufs for b in row]
        launch(0)
        shards = [(p, b, s) for row, brow, srow in zip(prog.shards, bufs, sums)
                  for p, b, s in zip(row, brow, srow)]
        for i, ((p, b, s), f_in) in enumerate(zip(shards, before)):
            pf, ps = p.plain_launch(f_in, b[1])
            _check_inplace(f"{n}x{n} {name} over {key}, shard {i}, 1 launch", b[0],
                           s[:prog.chunk], pf, ps, errs)
            del pf, ps
        del bufs, sums, before, shards
        torch.cuda.empty_cache()
    print(f"{n}x{n} {name}, one launch from the run's f against its plain version, every "
          f"shard of 2 and 4 rows: max|df| {errs['max_abs_err']}, sums rel "
          f"{errs['max_av_rtol']}", flush=True)
    rec["errs"] = errs

    # Times in turns by CUDA events, launches alone.
    xt = single.program
    runs = {"A single device": _bound_loop(xt, init_cells(params, dev), torch)}
    runs.update({key: _sharded_loop(prog, None, torch) for key, prog in progs.items()})
    order = list(runs) + list(runs)[::-1]
    timed = dict.fromkeys(runs, 200)
    warm = dict.fromkeys(runs, 8)
    times = _turns(runs, order, timed, torch, warm)
    for key, t in times.items():
        print(f"{n}x{n} {key}: {[round(x * 1e3, 3) for x in t]} us/step by CUDA events "
              f"| {card}", flush=True)
    rec["times_ms"] = times
    # The ghost copies' share of device time, from the profiler: each kind
    # of device op's mean per recorded call times its calls in the window,
    # since the profiler drops records of long kernels (_device_profile).
    # A launch is one shard kernel and one av_reduce_kernel on each shard,
    # after two ghost copies for each shard.
    from torch.profiler import ProfilerActivity, profile

    window = 40
    for key, prog in progs.items():
        run = runs[key]
        launches = window // prog.chunk * prog.mesh.size
        expected = {"kernel": launches, "reduce": launches, "copy": 2 * launches}
        run(8)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(window)
            torch.cuda.synchronize()
        kinds = {kind: [0.0, 0] for kind in expected}  # [device us, recorded calls]
        for e in prof.key_averages():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.self_device_time_total <= 0):
                continue
            kind = ("copy" if _is_copy(e.key) else "reduce" if "av_reduce" in e.key
                    else "kernel" if "lbm_shard_xt_kernel" in e.key else None)
            require(kind is not None, f"{n}x{n} {key}: unexpected device op {e.key}")
            kinds[kind][0] += e.self_device_time_total
            kinds[kind][1] += e.count
        us = {kind: t / calls * expected[kind] / window if calls else None
              for kind, (t, calls) in kinds.items()}
        total = None if None in us.values() else sum(us.values())
        rec["runs"][key]["profile"] = {
            "device_us_per_step": total,
            "ghost_copy_us_per_step": us["copy"],
            "ghost_copy_share": us["copy"] / total if total else None,
            "by_kind_us_per_step": us,
            "recorded_calls": {kind: calls for kind, (_, calls) in kinds.items()},
            "expected_calls": expected}
        p = rec["runs"][key]["profile"]
        print(f"{n}x{n} {key}, profiler over {window} steps (each op's mean per recorded "
              f"call times its expected calls): device {p['device_us_per_step']} us/step, "
              f"ghost copies {p['ghost_copy_us_per_step']} us/step (share "
              f"{p['ghost_copy_share']}), by kind {us}, calls recorded "
              f"{p['recorded_calls']} of {expected} | {card}", flush=True)
    del runs
    # Peak device memory of each run (allocation, bind, launches).
    peaks = {"A single device": _peak_bytes(
        lambda: single.program.bind(init_cells(params, dev),
                                    torch.empty(8, device=dev))(0), torch)}
    for key, prog in progs.items():
        peaks[key] = _peak_bytes(lambda prog=prog: prog.run(None, 2), torch)
    print(f"{n}x{n} peak device memory (allocation, bind, launches): "
          + ", ".join(f"{key} {v} B ({v / f_bytes:.4f} f)" for key, v in peaks.items())
          + f"; f is {f_bytes} B, a ping-pong pair 2 f | {card}", flush=True)
    for key, v in peaks.items():
        require(v < 2 * f_bytes, f"{n}x{n} {key}: peak {v} B is not below 2 f")
    rec["peak_bytes"] = peaks
    rec["cells"] = n * n
    f_dev = ref_f.to(dev)
    k = progs["B 2 rows"].chunk
    rec["plain_ms_runs"] = [_ms_per_step(
        lambda s: progs["B 2 rows"].run(f_dev, s // k, plain=True), k, torch, k)]
    return rec


def phase_shard_xt_cli(torch, card: str) -> dict:
    """``--shards 4 --temporal-split 32x4x2`` on 1024^2 x 20000 through the
    CLI: its launches counted, against tests/goldens at 1%, and its
    final_state.dat byte-identical to phase 4's single-device output."""
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops import fused

    rec = {"cases": {}, "launches": dict.fromkeys(fused.LAUNCHES, 0)}
    case, py, split = XT_SHARD_CLI
    flags = ["--shards", str(py), "--temporal-split", "x".join(map(str, split))]
    params = CANONICAL_PARAMS[case]
    label = f"{case} {' '.join(flags)}"
    d = WORK / "sharded_xt_1024x1024"
    want = dict.fromkeys(fused.LAUNCHES, 0)
    want["lbm_shard_temporal_xt_step"] = params.max_iters // split[1] * py
    _cli_run(label, ["run", *_case_files(case, d), *flags, "--output-dir", str(d)], want,
             rec)
    _check_goldens(label, case, params.max_iters, d, False, rec)
    _against_single(label, WORK / case, d, rec)
    c = rec["cases"][label]
    c["mlups"] = params.nx * params.ny * params.max_iters / c["elapsed_s"] / 1e6
    print(f"case {label}: launches {c['launches']}, {c['elapsed_s']:.6f} s timed "
          f"({c['wall_s']:.3f} s wall), {c['mlups']:.1f} MLUPS, worst deviation "
          + ", ".join(f"{k} {v:.4f}%" for k, v in c["worst_pct"].items()) + f" | {card}",
          flush=True)
    return rec


def _json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def phase_ablation(torch, card: str, seed0: int) -> dict:
    """The three ablation kernels against their plain versions, one pass at
    ABLATE_SHAPES (the 1024^2 tile of the tool's defaults first): noop and
    stream bitwise, collide's f bitwise equal to the production temporal
    kernel's (and to K plain one-steps); each kernel's and plain version's
    time per step at 1024^2; then the tool's own run (``python -m
    lbm_tpu_torch.tools.ablate_step``, defaults: 1024^2, 32x64, K 4, 4800
    steps, in turns), its launches counted."""
    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.tools import ablate_step

    dev = torch.device("cuda", 0)
    recs = {f"lbm_ablate_{m}": {"max_abs_err": 0.0, "by_shape": {}}
            for m in ablate_step.MODES}
    for seed, (ny, nx, by, bx, k) in enumerate(ABLATE_SHAPES, start=seed0):
        params, obstacles, fcinv, f0 = _setup(ny, nx, seed, dev, torch)
        progs = ablate_step.programs(params, obstacles, dev, by, bx, k)
        full_out = torch.empty_like(f0)
        progs["full"].bind(f0.clone(), full_out, torch.empty(k, device=dev))(0)
        for m in ablate_step.MODES:
            prog = progs[m]
            out = torch.empty_like(f0)
            prog.bind(f0.clone(), out)(0)
            torch.cuda.synchronize()
            plain = prog.plain_launch(f0)
            err = (out - plain).abs().max().item()
            rec = recs[prog.kernel]
            label = f"{prog.kernel} {nx}x{ny} tile {by}x{bx} K {k}"
            require(bool(out.isfinite().all()), f"{label}: non-finite f")
            require(err == 0.0, f"{label}: max|df| {err} against its plain version")
            extra = ""
            if m == "collide":
                full_err = (out - full_out).abs().max().item()
                require(full_err == 0.0, f"{label}: max|df| {full_err} against the "
                                         "production temporal kernel's f")
                extra = f"; against the production temporal kernel's f {full_err}"
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["by_shape"][f"{nx}x{ny}/{by}x{bx}/K{k}"] = err
            print(f"{label}: one pass against its plain version max|df| {err}{extra}",
                  flush=True)
            if (ny, nx) == (1024, 1024):
                loop = ablate_step.bound_loop(prog, f0)
                rec["ms_runs"] = [_ms_per_step(lambda s: loop(s // k), 400, torch, 40)
                                  for _ in range(2)]
                rec["plain_ms_runs"] = [_ms_per_step(lambda s: prog.plain_launch(f0), k,
                                                     torch, k) for _ in range(2)]
                rec["cells"], rec["tile"] = ny * nx, [by, bx, k]
            del out, plain
    buf = io.StringIO()
    fused.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = ablate_step.main([])
    launches = dict(fused.LAUNCHES)
    out = buf.getvalue()
    print("  " + out.strip().replace("\n", "\n  "))
    require(rc == 0, f"ablate_step returned {rc}")
    lines = _json_lines(out)
    modes = {r["mode"]: r for r in lines if "mode" in r}
    attribution = next(r for r in lines if "attribution_us" in r)
    for m in ablate_step.MODES:
        want = 2 * (1 + 3 * (4800 // 4))  # two turns of a warm-up pass and 3 loops
        require(launches[f"lbm_ablate_{m}"] == want,
                f"ablate_step: {launches[f'lbm_ablate_{m}']} launches of {m}, not {want}")
        recs[f"lbm_ablate_{m}"]["launches"] = launches[f"lbm_ablate_{m}"]
        recs[f"lbm_ablate_{m}"]["tool_us_per_step"] = modes[m]["us_per_step"]
    return {"kernels": recs, "modes": modes, "attribution": attribution,
            "launches": launches}


def phase_roofline(torch, card: str) -> dict:
    """The three roofline kernels against their plain versions, one launch
    at the tool's default shape from a seeded x with b = ROOFLINE_CHECK_B
    (every add moves x): add and fma bitwise, mix within ROOFLINE_MIX_RTOL
    relative, and the result away from x; each kernel's and plain
    version's time per launch; then the tool's own run (``python -m
    lbm_tpu_torch.tools.roofline``, defaults: lbm_tpu's constants), its
    launches counted, and the three rates."""
    import numpy as np

    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.tools import roofline

    dev = torch.device("cuda", 0)
    rows, unroll, inner, steps = 16896, 64, 200, 30  # the tool's defaults
    x = torch.from_numpy(np.random.default_rng(11).uniform(
        0.25, 1.5, rows * roofline.LANES).astype(np.float32)).to(dev)
    b = ROOFLINE_CHECK_B
    recs = {}
    for mix in roofline.MIXES:
        out = torch.empty_like(x)
        # The tool's inner, and 2: mix converges to its fixed point within
        # the first, so only the second shows a wrong iteration count.
        rel = err = 0.0
        for n_inner in (inner, 2):
            roofline.launch(mix, x, out, n_inner, unroll, b=b)
            plain = roofline.plain(mix, x, n_inner, unroll, b=b)
            torch.cuda.synchronize()
            rel = max(rel, ((out - plain).abs() / plain.abs()).max().item())
            err = max(err, (out - plain).abs().max().item())
            moved = (plain != x).double().mean().item()
            tol = ROOFLINE_MIX_RTOL if mix == "mix" else 0.0
            label = f"lbm_roofline_{mix} {rows}x128, inner {n_inner}, unroll {unroll}, b {b}"
            require(bool(out.isfinite().all()), f"{label}: non-finite result")
            # mix maps every x near one fixed point, which a few x may equal.
            require(moved == 1.0 if mix != "mix" else moved > 0.99,
                    f"{label}: the plain version left {1 - moved} of x unchanged")
            require(rel <= tol, f"{label}: max relative difference {rel} > {tol} against "
                                "its plain version")
            print(f"{label}: one launch against its plain version, max rel {rel}, x moved "
                  f"in {moved} of the elements", flush=True)
        ms = [_ms_per_step(lambda s: [roofline.launch(mix, x, out, inner, unroll)
                                      for _ in range(s)], 10, torch, 2) for _ in range(2)]
        plain_ms = [_ms_per_step(lambda s: roofline.plain(mix, x, inner, unroll), 1, torch,
                                 1)]
        recs[f"lbm_roofline_{mix}"] = {
            "max_abs_err": err, "max_rel_err": rel, "ms_runs": ms, "plain_ms_runs": plain_ms,
            "ops": rows * roofline.LANES * inner * roofline.issues_per_iteration(mix,
                                                                                 unroll),
            "bytes": 8 * rows * roofline.LANES}
        print(f"lbm_roofline_{mix} {rows}x128, inner {inner}, unroll {unroll}: "
              f"{[round(m, 4) for m in ms]} ms a launch, plain {plain_ms[0]:.1f} ms | "
              f"{card}", flush=True)
    buf = io.StringIO()
    fused.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = roofline.main([])
    launches = dict(fused.LAUNCHES)
    out = buf.getvalue()
    print("  " + out.strip().replace("\n", "\n  ") + f" | {card}")
    require(rc == 0, f"roofline returned {rc}")
    rates = {r["mix"]: r for r in _json_lines(out)}
    for mix in roofline.MIXES:
        want = 4 * steps  # a warm-up chain and three timed chains
        require(launches[f"lbm_roofline_{mix}"] == want,
                f"roofline: {launches[f'lbm_roofline_{mix}']} launches of {mix}, not {want}")
        recs[f"lbm_roofline_{mix}"]["launches"] = launches[f"lbm_roofline_{mix}"]
    return {"kernels": recs, "rates": rates, "launches": launches}


def _ulps16(a, b, torch) -> tuple[int, int]:
    """(the largest distance in 16-bit steps, the number of values that
    differ at all) between two tensors of one 16-bit dtype."""
    d = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
    return int(d.max()), int((d > 0).sum())


def phase_temporal16(torch, card: str, seed0: int) -> dict:
    """The 16-bit-storage temporal kernel against its plain version (the
    fp32 window pass on the widened f, rounded to nearest even) at
    TEMPORAL16_SHAPES, float16 and bfloat16, from a seeded f0 rounded to
    the storage type: f within one 16-bit step after one launch and after
    1000 steps (the cells that differ at all counted), av within
    TOL_AV16_1 relative after one launch and TOL_AV_N after 1000 steps;
    each program's persistent grid printed, and at 512x448 at least three
    tiles a block required.  Then, at the canonical 1024^2 case and at
    4096^2 (the weak-scaling grid, BASELINE.json configs[4], as phase 7
    sets it up) at the chooser's tile, in turns by CUDA events, the fp32
    temporal kernel and both 16-bit types, every turn from one developed
    state (TURNS16: the time a step depends on the state, and the timer's
    runs start from the uniform one), at 1024^2 the float16 f also bound
    OFFSET16 values into its allocation (4-byte copies in place of 8-byte
    ones); the plain versions' times at 1024^2."""
    import dataclasses

    import numpy as np

    from lbm_tpu_torch.config import CANONICAL_PARAMS, LBMParams
    from lbm_tpu_torch.geometry import canonical_obstacles, channel_box, free_cells_of
    from lbm_tpu_torch.ops import fused, schedule
    from lbm_tpu_torch.ops.reference import init_cells

    dev = torch.device("cuda", 0)
    rec = {"max_ulps": 0, "max_abs_err": 0.0, "max_av_rtol": 0.0,
           "max_av_rtol_1000": 0.0, "by_shape": {}, "times": {}}
    for seed, (ny, nx, by, bx, k) in enumerate(TEMPORAL16_SHAPES, start=seed0):
        params, obstacles, fcinv, f32 = _setup(ny, nx, seed, dev, torch)
        for storage in (torch.float16, torch.bfloat16):
            name = str(storage).removeprefix("torch.")
            f0 = f32.to(storage)
            prog = fused.TemporalStep(params, obstacles, fcinv, dev, by, bx, k,
                                      storage=storage)
            tiles = (ny // by) * (nx // bx)
            passes = -(-N_STEPS // k)
            k1, kav1 = _run_kernel(prog, f0, 1, torch)
            kn, kavn = _run_kernel(prog, f0, passes, torch)
            torch.cuda.synchronize()
            p1, pav1 = _run_plain(prog, f0, 1, torch)
            pn, pavn = _run_plain(prog, f0, passes, torch)
            u1, d1 = _ulps16(k1, p1, torch)
            un, dn = _ulps16(kn, pn, torch)
            err1, av1 = _errs(k1.float(), kav1, p1.float(), pav1)
            _, avn = _errs(kn.float(), kavn, pn.float(), pavn)
            label = f"temporal16 {name} {nx}x{ny} tile {by}x{bx} K {k}"
            grid = (f"{tiles} tiles on {prog.nblocks} blocks ({tiles // prog.nblocks} a "
                    f"block, {tiles % prog.nblocks} left over)")
            print(f"{label}: against its plain version 1 pass {d1} value(s) differ, at "
                  f"most {u1} step(s), max|df| {err1:.3e}, av rel {av1:.3e}; "
                  f"{passes * k} steps {dn} differ, at most {un} step(s), av rel "
                  f"{avn:.3e}; grid {grid}", flush=True)
            require(bool(kn.float().isfinite().all()), f"{label}: non-finite f")
            require(u1 <= 1 and un <= 1, f"{label}: f more than one {name} step from "
                                         f"its plain version ({u1}, {un})")
            require(av1 <= TOL_AV16_1, f"{label}: 1-pass av rel {av1} > {TOL_AV16_1}")
            require(avn <= TOL_AV_N, f"{label}: {passes * k}-step av rel {avn} > "
                                     f"{TOL_AV_N}")
            if (ny, nx) == (512, 448):
                require(tiles >= PREFETCH_TILES_A_BLOCK * prog.nblocks,
                        f"{label}: {grid}, fewer than {PREFETCH_TILES_A_BLOCK} tiles a "
                        "block")
            rec["by_shape"][f"{name}/{nx}x{ny}/{by}x{bx}/K{k}"] = {
                "ulps_1": u1, "differ_1": d1, "ulps_1000": un, "differ_1000": dn,
                "err_1": err1, "av_rtol_1": av1, "av_rtol_1000": avn,
                "grid": [tiles, prog.nblocks]}
            rec["max_ulps"] = max(rec["max_ulps"], u1, un)
            rec["max_abs_err"] = max(rec["max_abs_err"], err1)
            rec["max_av_rtol"] = max(rec["max_av_rtol"], av1)
            rec["max_av_rtol_1000"] = max(rec["max_av_rtol_1000"], avn)
            if (ny, nx) == (1024, 1024):
                rec["times"][name] = {
                    "plain_ms_runs": [_ms_per_step(lambda s: prog.plain_launch(f0), k,
                                                   torch, k) for _ in range(2)],
                    "tile": [by, bx, k], "cells": ny * nx}
            del k1, kn, p1, pn
    rec["turns"] = {}
    for n, steps, develop in TURNS16:
        if n == 1024:
            params = dataclasses.replace(CANONICAL_PARAMS["1024x1024"], max_iters=steps)
            obstacles = canonical_obstacles("1024x1024")
        else:
            params = LBMParams(n, n, steps, 10, 0.1, 0.005, 1.85)
            obstacles = channel_box(n, n)
        fcinv = np.float32(1.0) / np.float32(free_cells_of(obstacles))
        tile = schedule.choose_temporal(n, n, steps)
        fp32 = fused.TemporalStep(params, obstacles, fcinv, dev, *tile)
        f_dev, _ = _run_kernel(fp32, init_cells(params, dev), develop // tile[2], torch)
        require(bool(f_dev.isfinite().all()), f"{n}x{n}: the developed state is not finite")
        runs = {"A float32": _bound_loop(fp32, f_dev, torch, reset=True)}
        for name, storage in (("float16", torch.float16), ("bfloat16", torch.bfloat16)):
            prog = fused.TemporalStep(params, obstacles, fcinv, dev, *tile, storage=storage)
            runs[f"{'B' if name == 'float16' else 'D'} {name}"] = _bound_loop(
                prog, f_dev.to(storage), torch, reset=True)
            if n == 1024 and name == "float16":
                runs[f"C float16 at offset {OFFSET16}"] = _bound_loop(
                    prog, f_dev.to(storage), torch, offset=OFFSET16, reset=True)
        names = sorted(runs)
        times = _turns(runs, names + names[::-1], dict.fromkeys(runs, steps), torch,
                       dict.fromkeys(runs, 40))
        for name in names:
            ms = times[name]
            print(f"temporal16 {n}x{n} turns {name}, tile {tile[0]}x{tile[1]} K {tile[2]}, "
                  f"from {develop} steps of flow: {sum(ms) / len(ms) * 1e3:.3f} us a step by "
                  f"CUDA events ({[round(r * 1e3, 3) for r in ms]}) | {card}", flush=True)
        rec["turns"][f"{n}x{n}"] = {"tile": list(tile), "developed_steps": develop,
                                    "times_ms": times}
        if n == 1024:
            rec["times"]["float16"]["ms_runs"] = times["B float16"]
            rec["times"]["bfloat16"]["ms_runs"] = times["D bfloat16"]
        del runs, f_dev
    return rec


def _tool(label: str, main, argv: list) -> tuple[int, str, dict]:
    """``main(argv)`` of a tool or the CLI with every launch count set to 0
    just before and read just after: (exit code, its output, launches)."""
    from lbm_tpu_torch.ops import fused

    buf = io.StringIO()
    fused.reset_launches()
    tic = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    launches = dict(fused.LAUNCHES)
    out = buf.getvalue()
    print(f"  $ {label} ({time.perf_counter() - tic:.3f} s)\n  "
          + out.strip().replace("\n", "\n  "), flush=True)
    return rc, out, launches


def _add_launches(rec: dict, launches: dict) -> None:
    for name, count in launches.items():
        rec["launches"][name] += count


def _bounds16(cells: int, k: int, itemsize: int, issue_rate: float) -> dict:
    """A temporal pass's least time a step at ``itemsize``-byte storage: its
    bytes (9 populations in and out, the mask byte in, once a pass) at the
    published rate, and its 104 fp32 operations an update at the measured
    issue rate (the 18 conversions an update of 16-bit storage not
    counted)."""
    bound_ms, by = _bound_ms((2 * 9 * itemsize + 1) * cells / k, OPS_PER_UPDATE * cells)
    return {"bound_ms": bound_ms, "bound_by": by,
            "bound_ms_issue": OPS_PER_UPDATE * cells / issue_rate * 1e3}


def phase_tuning(torch, card: str, issue_rate: float, seed: int) -> dict:
    """The tuning path: ``fp16_experiment time`` (fp32, bf16 and fp16 at the
    chooser's tile at 1024^2 and 4096^2, each beside its bounds) and
    ``drift`` (256^2 x 80000 and 1024^2 x 20000 in all three types: fp32
    within 1% of the goldens, the 16-bit runs finite, their drift
    recorded); then ``lbm autotune`` with the cache in a temporary
    directory: a sweep at 1024^2 that writes ranked, stamped entries, a
    --dry-run that leaves the file as it was, a --refresh that re-times
    only the incumbents, the CLI run of 1024^2 x 20000 taking the cached
    winner (files within 1% of the goldens; its program held against its
    plain version), and a --dry-run sweep at 8192^2 that runs the
    x-tiled timer."""
    import os
    import tempfile

    from lbm_tpu_torch import cli, tuning
    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops import fused, schedule
    from lbm_tpu_torch.tools import fp16_experiment

    rec = {"launches": dict.fromkeys(fused.LAUNCHES, 0), "times": {}, "drift": {},
           "autotune": {}, "cases": {}}
    kernel_of = {"float32": "lbm_temporal_step", "bfloat16": "lbm_temporal16_step",
                 "float16": "lbm_temporal16_step"}
    itemsize = {"float32": 4, "bfloat16": 2, "float16": 2}

    # (c) Times at the chooser's tile, by the autotuner's timer.
    for grid, steps in TIME16_RUNS:
        argv = ["time", "--grid", grid] + (["--steps", str(steps)] if steps else [])
        rc, out, launches = _tool(f"fp16_experiment {' '.join(argv)}",
                                  fp16_experiment.main, argv)
        require(rc == 0, f"fp16_experiment time {grid} returned {rc}")
        rows = {r["storage"]: r for r in _json_lines(out) if "storage" in r}
        ny, nx = (int(v) for v in grid.split("x"))
        want = dict.fromkeys(fused.LAUNCHES, 0)
        for name, r in rows.items():
            require(r["us_per_step"] is not None, f"fp16_experiment time {grid}: {name} "
                                                  "did not run")
            want[kernel_of[name]] += 4 * (r["steps"] // r["k"])  # warm-up, 3 repeats
            r.update(_bounds16(ny * nx, r["k"], itemsize[name], issue_rate))
            print(f"time {grid} {name}: {r['us_per_step']} us a step at tile "
                  f"{r['by']}x{r['bx']} K {r['k']}; bound {r['bound_ms'] * 1e3} us "
                  f"({r['bound_by']}), issue floor {r['bound_ms_issue'] * 1e3} us "
                  f"| {card}", flush=True)
        require(set(rows) == set(kernel_of), f"fp16_experiment time {grid}: rows "
                                             f"{sorted(rows)}")
        require(launches == want, f"fp16_experiment time {grid}: launches {launches}, "
                                  f"expected {want}")
        _add_launches(rec, launches)
        rec["times"][grid] = rows

    # (d) Drift against the goldens, full length.
    for case in DRIFT_CASES:
        for name in ("float32", "float16", "bfloat16"):
            argv = ["drift", "--case", case, "--storage", name]
            rc, out, launches = _tool(f"fp16_experiment {' '.join(argv)}",
                                      fp16_experiment.main, argv)
            r = _json_lines(out)[-1]
            label = f"drift {case} {name}"
            require(r["finite"], f"{label}: non-finite av")
            require(rc == (0 if r["pass"] else 1), f"{label}: exit {rc}, pass {r['pass']}")
            if name == "float32":
                require(r["pass"] and r["max_pct"] < 1.0,
                        f"{label}: the fp32 control is {r['max_pct']}% off the goldens")
            want = dict.fromkeys(fused.LAUNCHES, 0)
            want[kernel_of[name]] = r["steps"] // r["k"]
            require(launches == want, f"{label}: launches {launches}, expected {want}")
            _add_launches(rec, launches)
            rec["drift"][f"{case}/{name}"] = r
            print(f"{label}: max {r['max_pct']}% at step {r['argmax_step']}, p99 "
                  f"{r['p99_pct']}%, final {r['final_pct']}%, Re {r['reynolds']} against "
                  f"{r['reynolds_golden']}, pass {r['pass']} | {card}", flush=True)

    # (e) lbm autotune, the cache in a temporary directory.
    kind = tuning.default_device_kind()
    calls = []
    timer = tuning.time_temporal_candidate

    def counted(*args, **kwargs):
        calls.append(args[2:5] + (kwargs.get("schedule", "temporal"),))
        return timer(*args, **kwargs)

    old_env = os.environ.get("LBM_TUNING_CACHE")
    tuning.time_temporal_candidate = counted
    try:
        WORK.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=WORK) as tmp:
            cache = pathlib.Path(tmp) / "tuning_cache.json"
            os.environ["LBM_TUNING_CACHE"] = str(cache)
            # 1. A sweep at 1024^2 writes ranked, stamped entries.
            rc, out, launches = _tool("autotune --case 1024x1024", cli.main,
                                      ["autotune", "--case", "1024x1024"])
            require(rc == 0, f"autotune --case 1024x1024 returned {rc}")
            raw = json.loads(cache.read_text())
            entries = raw.get(f"{kind}|1024x1024", [])
            stamp = raw.get(tuning.META_KEY, {}).get(f"{kind}|1024x1024", {})
            times = [e[3] for e in entries]
            require(0 < len(entries) <= len(calls) and times == sorted(times),
                    f"autotune: {len(entries)} entries for {len(calls)} candidates, "
                    "or not ranked")
            require(stamp.get("recorded") and stamp.get("steps") == 960
                    and stamp.get("repeats") == 3, f"autotune: provenance {stamp}")
            _add_launches(rec, launches)
            rec["autotune"]["sweep"] = {"entries": entries, "stamp": stamp,
                                        "candidates": len(calls)}
            winner = tuning.lookup(kind, 1024, 1024)[0]
            fixed = schedule.fixed_temporal(1024, 1024, 20000)
            fixed_us = next((e[3] for e in entries if tuple(e[:3]) == fixed), None)
            print(f"autotune 1024x1024: {len(entries)} ranked entries, winner {winner} at "
                  f"{entries[0][3]} us a step; the fixed order's {fixed} at {fixed_us} | "
                  f"{card}", flush=True)
            # 2. --dry-run leaves the file byte for byte (a short sweep).
            before = cache.read_bytes()
            argv = ["autotune", "--case", "1024x1024", "--steps", "240", "--repeats", "1",
                    "--dry-run"]
            rc, _, launches = _tool(" ".join(argv), cli.main, argv)
            require(rc == 0 and cache.read_bytes() == before,
                    "autotune --dry-run changed the cache or failed")
            _add_launches(rec, launches)
            # 3. --refresh re-times only the incumbents.
            calls.clear()
            rc, out, launches = _tool("autotune --case 1024x1024 --refresh", cli.main,
                                      ["autotune", "--case", "1024x1024", "--refresh"])
            incumbents = [tuple(e[:3]) + (e[4],) for e in entries]
            require(rc == 0 and sorted(calls) == sorted(incumbents)
                    and "falling back" not in out,
                    f"autotune --refresh timed {len(calls)} candidates, not the "
                    f"{len(incumbents)} incumbents")
            _add_launches(rec, launches)
            rec["autotune"]["refresh"] = json.loads(cache.read_text())[f"{kind}|1024x1024"]
            # 4. The CLI run takes the cached winner.
            winner = tuning.lookup(kind, 1024, 1024)[0]
            require(winner[3] == "temporal", f"autotune: 1024^2 winner {winner}")
            case = "1024x1024"
            params = CANONICAL_PARAMS[case]
            tile = tuple(winner[:3])
            require(schedule.choose_schedule(params.ny, params.nx, params.max_iters)
                    == ("temporal", tile), "the chooser did not take the cached winner")
            d = WORK / "1024x1024_tuned"
            label = f"{case} with the tuned cache"
            out = _cli_run(label, ["run", *_case_files(case, d), "--output-dir", str(d)],
                           _expected_launches("temporal", tile, params.max_iters), rec)
            require(f"TemporalStep (steps/launch {tile[2]}, tile {tile[0]}x{tile[1]}, "
                    f"K {tile[2]})" in out, f"{label}: the run did not print the cached "
                    f"tile {tile}")
            _check_goldens(label, case, params.max_iters, d, False, rec)
            dev = torch.device("cuda", 0)
            p, obstacles, fcinv, f0 = _setup(1024, 1024, seed, dev, torch)
            prog = fused.TemporalStep(p, obstacles, fcinv, dev, *tile)
            passes = -(-N_STEPS // tile[2])
            k1, kav1 = _run_kernel(prog, f0, 1, torch)
            kn, kavn = _run_kernel(prog, f0, passes, torch)
            p1, pav1 = _run_plain(prog, f0, 1, torch)
            pn, pavn = _run_plain(prog, f0, passes, torch)
            err1, _ = _errs(k1, kav1, p1, pav1)
            errn, avn = _errs(kn, kavn, pn, pavn)
            _check(f"{label}: its program", err1, errn, avn, kn)
            c = rec["cases"][label]
            c.update(tile=list(tile), err_1=err1, err_1000=errn, av_rtol_1000=avn,
                     mlups=params.nx * params.ny * params.max_iters / c["elapsed_s"] / 1e6)
            print(f"case {label}: tile {tile}, {c['elapsed_s']:.6f} s timed, "
                  f"{c['mlups']:.1f} MLUPS, worst deviation {c['worst_pct']}; its program "
                  f"against its plain version 1 pass {err1:.3e}, {passes * tile[2]} steps "
                  f"{errn:.3e}, av rel {avn:.3e} | {card}", flush=True)
            # 5. The x-tiled timer at 8192^2.
            calls.clear()
            before = cache.read_bytes()
            rc, out, launches = _tool(
                "autotune --grid 8192x8192 --steps 16 --repeats 1 --dry-run", cli.main,
                ["autotune", "--grid", "8192x8192", "--steps", "16", "--repeats", "1",
                 "--dry-run"])
            xt_timed = sum(c[3] == "xtiled" for c in calls)
            best = _json_lines(out)[-1]
            require(rc == 0 and xt_timed > 0 and launches["lbm_temporal_xt_step"] > 0
                    and cache.read_bytes() == before,
                    f"autotune 8192^2: exit {rc}, {xt_timed} x-tiled candidates timed, "
                    f"{launches['lbm_temporal_xt_step']} x-tiled launches")
            _add_launches(rec, launches)
            rec["autotune"]["8192x8192"] = {"best": best, "candidates": len(calls),
                                            "xtiled": xt_timed}
            print(f"autotune 8192x8192 (16 steps, 1 repeat): {len(calls)} candidates, "
                  f"{xt_timed} x-tiled; best {best} | {card}", flush=True)
    finally:
        tuning.time_temporal_candidate = timer
        if old_env is None:
            os.environ.pop("LBM_TUNING_CACHE", None)
        else:
            os.environ["LBM_TUNING_CACHE"] = old_env
    return rec


def _mps_running() -> bool:
    """Whether an MPS control daemon or server runs on this host."""
    for comm in pathlib.Path("/proc").glob("[0-9]*/comm"):
        try:
            if comm.read_text().startswith("nvidia-cuda-mps"):
                return True
        except OSError:
            continue
    return False


def _exchange_channels(torch, grid: str, args: list, shards: int,
                       by_columns: bool = False) -> dict:
    """The messages process 0 of a two-process run of ``multihost_smoke``
    sends and receives (``ipc.Channel``s, by label), built as its
    exchanges build them: the run's program made in this process, its
    buffers on the card, split over the two processes' positions (or, with
    ``by_columns``, a process a column, so that the x phase crosses)."""
    import numpy as np

    from lbm_tpu_torch.parallel import ipc
    from lbm_tpu_torch.parallel.halo import GhostExchange, HaloExchange, SlabLayout
    from lbm_tpu_torch.parallel.mesh import default_mesh, default_mesh_2d
    from lbm_tpu_torch.tools import multihost_smoke as mh

    class Recorder:
        def link(self, phases):
            self.phases = phases
            return self

    params, obstacles = mh._case(grid, MULTIHOST_STEPS)
    mesh = (default_mesh_2d(2, 2) if "--mesh" in args else default_mesh(shards))
    split = args[args.index("--temporal-split") + 1] if "--temporal-split" in args else None
    kernel = args[args.index("--kernel") + 1]
    program = mh._simulator(params, obstacles, mesh, kernel, mh._split(split)).compiled()
    bufs, _ = program.alloc()
    procs = np.arange(mesh.size).reshape(mesh.py, mesh.px) // (mesh.size // 2)
    if by_columns:
        procs = np.tile(np.arange(mesh.px), (mesh.py, 1)) * 2 // mesh.px
    rec = Recorder()
    if isinstance(program.layout, SlabLayout):
        GhostExchange([(row[0][0], row[0][1]) for row in bufs], program.layout, procs,
                      rank=0, transport=rec)
    else:
        HaloExchange([[b[0] for b in row] for row in bufs], program.layout, procs,
                     rank=0, transport=rec)
    out = {}
    for ph in rec.phases:
        for kind, messages in (("send", ph.sends), ("recv", ph.recvs)):
            for ch in ipc.channels(ph.number, messages):
                out[f"{grid} {' '.join(args)}{' by columns' * by_columns}: {kind} phase "
                    f"{ph.number}"] = ch
    for ch in out.values():
        for v in ch.views:
            v.copy_(torch.rand(v.shape, device=v.device))
    return out


def phase_exchange_kernels(torch, card: str) -> dict:
    """The exchange kernels on every message of phase 12's runs: each
    bitwise its plain version (pack, then unpack of the same mailbox into
    zeroed pieces), then the kernel, its plain version and
    ``torch._foreach_copy_`` (one PyTorch call that computes the same
    copies) in turns (kernel, plain, library, library, plain, kernel), a
    turn one replay of a CUDA graph of EXCHANGE_TIMED calls, by CUDA
    events: device time, which a loop of eager calls from Python would
    not show (a call's host time exceeds these kernels'); the kernel's
    eager time a launch beside it."""
    from lbm_tpu_torch.parallel import ipc

    rec = {name: {"by_message": {}, "max_abs_err": 0.0} for name in EXCHANGE_KERNELS}

    def events_ms(run) -> float:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / EXCHANGE_TIMED

    def graphed(fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(EXCHANGE_TIMED):
                fn()
        return graph

    def eager(fn):
        def run():
            for _ in range(EXCHANGE_TIMED):
                fn()
        return run

    # Every run's messages, and the x phase's strided pieces of the 2x2
    # mesh split by columns (bitwise only: no run of phase 12 sends them).
    cases = [(*run, False) for run in MULTIHOST_RUNS] + [(*MULTIHOST_RUNS[1], True)]
    for grid, args, _, shards, by_columns in cases:
        for label, ch in _exchange_channels(torch, grid, args, shards, by_columns).items():
            box = torch.empty(ch.numel, device=ch.views[0].device)
            plain_box = torch.empty_like(box)
            ipc.exchange_pack(ch, box)
            ipc.pack_plain(ch, plain_box)
            pieces = [v.clone() for v in ch.views]
            torch.cuda.synchronize()
            pack_err = float((box - plain_box).abs().max())
            require(torch.equal(box, plain_box), f"lbm_exchange_pack {label}: not bitwise "
                                                 f"its plain version ({pack_err})")
            for v in ch.views:
                v.zero_()
            ipc.exchange_unpack(ch, box)
            torch.cuda.synchronize()
            require(all(torch.equal(v, w) for v, w in zip(ch.views, pieces)),
                    f"lbm_exchange_unpack {label}: not bitwise its plain version")
            rec["checked"] = rec.get("checked", []) + [label]
            if by_columns:
                continue
            slots = [box[off:off + v.numel()].view(v.shape)
                     for v, off in zip(ch.views, ch.offsets)]
            fns = {
                "lbm_exchange_pack": (lambda: ipc.exchange_pack(ch, box),
                                      lambda: ipc.pack_plain(ch, plain_box),
                                      lambda: torch._foreach_copy_(slots, ch.views)),
                "lbm_exchange_unpack": (lambda: ipc.exchange_unpack(ch, box),
                                        lambda: ipc.unpack_plain(ch, box),
                                        lambda: torch._foreach_copy_(ch.views, slots)),
            }
            for name, (kernel, plain, library) in fns.items():
                graphs = {"kernel": graphed(kernel), "plain": graphed(plain),
                          "library": graphed(library)}
                times = {"kernel": [], "plain": [], "library": []}
                for which in ("kernel", "plain", "library", "library", "plain", "kernel"):
                    graphs[which].replay()
                    times[which].append(events_ms(graphs[which].replay))
                del graphs
                kernel()
                eager_ms = events_ms(eager(kernel))
                mean = {k: sum(v) / len(v) for k, v in times.items()}
                nbytes = 2 * 4 * ch.numel  # each element read once, written once
                bound, by = _bound_ms(nbytes, 0)
                rec[name]["by_message"][label] = {
                    "pieces": len(ch.views), "shapes": [list(v.shape) for v in ch.views],
                    "bytes": nbytes, "ms": mean["kernel"], "plain_ms": mean["plain"],
                    "library_ms": mean["library"], "turns_ms": times, "eager_ms": eager_ms,
                    "bound_ms": bound, "bound_by": by}
                print(f"  {name} {label}: {len(ch.views)} pieces "
                      f"{[list(v.shape) for v in ch.views]}, {nbytes} B: "
                      f"{mean['kernel'] * 1e3:.2f} us a launch in a graph ({eager_ms * 1e3:.2f} "
                      f"launched from Python), plain {mean['plain'] * 1e3:.2f}, "
                      f"torch._foreach_copy_ {mean['library'] * 1e3:.2f}, bound "
                      f"{bound * 1e3:.3f} (bytes); bitwise | {card}", flush=True)
    return rec


def phase_multihost(card: str) -> dict:
    """Phase 12: each of MULTIHOST_RUNS through ``multihost_smoke``'s
    coordinator, both workers on device 0.  Requires exit 0 and the PASS
    banner (every check of the workers held), the device transport, and
    the launches of the workers' checkpointed runs: steps / chunk a shard
    of its kernel, and a pack and an unpack a message of every exchange."""
    import torch

    from lbm_tpu_torch.ops import fused

    torch.cuda.empty_cache()  # the card's memory to the workers, not this idle process
    # Two processes time-slice the card unless an MPS daemon serves them; the
    # compute mode is printed beside the runs.
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    mps = _mps_running()
    print(f"  compute mode: {mode}; MPS daemon running: {mps} | {card}")
    rec = {"launches": {name: 0 for name in fused.LAUNCHES}, "runs": {}, "compute_mode": mode,
           "mps": mps}
    env = dict(os.environ, LBM_DEVICE="0")
    for grid, args, kernel, shards in MULTIHOST_RUNS:
        label = f"{grid} {' '.join(args)}"
        tic = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "lbm_tpu_torch.tools.multihost_smoke",
             "--grid", grid, "--steps", str(MULTIHOST_STEPS), *args],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - tic
        out = proc.stdout.strip()
        require(proc.returncode == 0, f"multihost_smoke {label}: exit {proc.returncode}\n"
                                      f"{out[-3000:]}\n{proc.stderr[-3000:]}")
        procs = 2
        local = shards // procs
        topo = "mesh 2x2" if "--mesh" in args else "1-D mesh"
        banner = f"PASS: {procs} processes x {local} devices ({topo})"
        require(banner in out, f"multihost_smoke {label}: no {banner!r}")
        summary = json.loads(out.splitlines()[-1])
        require(summary["transport"] == "ipc",
                f"multihost_smoke {label}: transport {summary['transport']!r}, not 'ipc'")
        exchanges = MULTIHOST_STEPS // summary["chunk"]
        want = {kernel: exchanges * shards,
                **dict.fromkeys(EXCHANGE_KERNELS, exchanges * summary["send_channels"])}
        require(summary["send_channels"] > 0 and summary["launches"] == want,
                f"multihost_smoke {label}: launches {summary['launches']}, expected {want}")
        for name, count in want.items():
            rec["launches"][name] += count
        plain = summary["plain"]
        require(all(p is not None and p["max_abs_err"] == 0.0 for p in plain),
                f"multihost_smoke {label}: the kernel against its plain version: {plain}")
        summary.update(wall_s=wall, kernel_name=kernel, grid=grid,
                       max_abs_err=max(p["max_abs_err"] for p in plain),
                       max_av_rtol=max(p["max_av_rtol"] for p in plain))
        rec["runs"][label] = summary
        ex = summary["exchange"]
        turns = "; ".join(
            f"{name} {e['exchange_us']:.2f} us (turns {', '.join(f'{t:.2f}' for t in e['turns_us'])};"
            f" start {e['start_us']:.2f}, finish {e['finish_us']:.2f})"
            for name, e in ex.items())
        print(f"  {label}: {grid} x {MULTIHOST_STEPS} over {summary['mesh']} "
              f"({summary['variant']}, chunk {summary['chunk']}, transport "
              f"{summary['transport']}; resumed over {summary['resume_mesh']}): "
              f"{summary['us_per_step']:.2f} us a step over 2 processes against "
              f"{summary['us_per_step_one_process']:.2f} over 1 process; the exchange alone "
              f"in turns: {turns}; {summary['exchange_share_of_launch']:.4f} of a launch "
              f"({summary['launch_us']:.2f} us); {summary['pieces']} pieces crossing a "
              f"process, {summary['send_channels']} messages an exchange; one gloo message "
              f"of {summary['message_bytes']} B host to host {summary['message_us']:.2f} us; "
              f"launches {summary['launches']}; {wall:.1f} s | {card} (two processes on one "
              f"card: not a multi-GPU rate)", flush=True)
    return rec


def _bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    """The least time for the work on this card (published rates), and
    which of the two bounds it."""
    t_bytes, t_ops = bytes_moved / MEM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def _inplace_entry(name, source, replaces, launches, errs, times, t_name, profile,
                   plain_runs, steps_per_launch, band_floats, cells, card,
                   **extra) -> dict:
    """A kernels-line entry of an in-place kernel.  Its ``bound_ms`` is the
    function's (73 B a cell once per ``steps_per_launch`` steps, as the
    temporal kernel's); ``bound_ms_inplace_bytes`` adds the band parity
    that the in-place design reads and the one it writes."""
    from lbm_tpu_torch.utils.profiling import BYTES_PER_CELL

    bound, by = _bound_ms(BYTES_PER_CELL * cells / steps_per_launch,
                          OPS_PER_UPDATE * cells)
    inplace_bytes = (BYTES_PER_CELL * cells + 2 * 4 * band_floats) / steps_per_launch
    mean = sum(times[t_name]) / len(times[t_name])
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": errs["max_abs_err"],
        "max_av_rtol": errs["max_av_rtol"],
        "max_abs_err_1000_steps": errs["max_abs_err_1000"],
        "av_rtol_1000_steps": errs["max_av_rtol_1000"],
        "errors_by_shape": errs["by_shape"], "per": "step", "ms": mean,
        "ms_turns": times[t_name], "device_us": profile["device_us"],
        "plain_ms": sum(plain_runs) / len(plain_runs), "bound_ms": bound, "bound_by": by,
        "bound_ms_inplace_bytes": inplace_bytes / MEM_BYTES_PER_S * 1e3,
        "library_ms": None, **extra, "card": card,
    }


def _shard_entry(name, source, replaces, launches, errs, big, card) -> dict:
    """A kernels-line entry of a shard kernel, timed at the weak-scaling
    grid (every shard's launches of one step, no exchange); its bound is
    the function's bytes (each shard's tile with its halo read once, its
    owned cells written once) or its operations.  ``max_abs_err`` and
    ``max_av_rtol`` cover every shape it was held at, ``shape``'s
    included (``*_shape``: one launch there, every shard)."""
    k = big["kernels"][name]
    cells = SHARD_BIG * SHARD_BIG
    bound, by = _bound_ms(k["bytes_per_step"], OPS_PER_UPDATE * cells)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(errs["max_abs_err"], k["errs"]["max_abs_err"]),
        "max_av_rtol": max(errs["max_av_rtol"], k["errs"]["max_av_rtol"]),
        "max_abs_err_shape": k["errs"]["max_abs_err"],
        "sums_rtol_shape": k["errs"]["max_av_rtol"],
        "max_abs_err_1000_steps": errs["max_abs_err_1000"],
        "av_rtol_1000_steps": errs["max_av_rtol_1000"],
        "errors_by_shape": errs["by_shape"], "per": "step",
        "shape": (f"{SHARD_BIG}x{SHARD_BIG} over {k['mesh']}, tiles "
                  f"{k['tile'][0]}x{k['tile'][1]}, halo {k['halo']}"
                  + (f", temporal tiles {k['temporal_tile'][0]}x{k['temporal_tile'][1]}"
                     if k["temporal_tile"] else "")),
        "ms": sum(k["ms_runs"]) / len(k["ms_runs"]), "ms_runs": k["ms_runs"],
        "device_us": k["device_us"],
        "plain_ms": sum(k["plain_ms_runs"]) / len(k["plain_ms_runs"]),
        "bound_ms": bound, "bound_by": by, "library_ms": None, "card": card,
    }


def _new_entries(launches, xkrec, xbig, arec, rrec, card) -> list:
    """The kernels-line entries of the shard x-tiled kernel, the ablation
    kernels and the roofline kernels."""
    from lbm_tpu_torch.utils.profiling import BYTES_PER_CELL

    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    out = []
    name = "lbm_shard_temporal_xt_step"
    errs, b = xkrec[name], xbig["runs"]["B 2 rows"]
    n, k, shards = xbig["runs"]["B 2 rows"]["slab"][1], b["k"], b["shards"]
    # The function's bytes a step: each shard reads its slab and its 2K
    # ghost rows once (9 fp32 and the mask byte a cell) and writes its slab
    # once, per pass of K steps.
    fn_bytes = (BYTES_PER_CELL * n * n + shards * 2 * k * n * 37) / k
    bound, bound_by = _bound_ms(fn_bytes, OPS_PER_UPDATE * n * n)
    out.append({
        "name": name, "route": "cuda", "source": "lbm_tpu_torch/csrc/lbm_temporal_xt.cu",
        "replaces": "lbm_tpu/ops/fused.py:1075",
        "as_used_by": "lbm_tpu/parallel/sharded.py:987-1199",
        "launches": launches[name],
        "max_abs_err": max(errs["max_abs_err"], xbig["errs"]["max_abs_err"]),
        "max_av_rtol": max(errs["max_av_rtol"], xbig["errs"]["max_av_rtol"]),
        "max_abs_err_shape": xbig["errs"]["max_abs_err"],
        "sums_rtol_shape": xbig["errs"]["max_av_rtol"],
        "max_abs_err_1000_steps": errs["max_abs_err_1000"],
        "av_rtol_1000_steps": errs["max_av_rtol_1000"], "errors_by_shape": errs["by_shape"],
        "per": "step",
        "shape": (f"{n}x{n} over {shards} rows, {b['slab'][0]}x{n} slabs, tiles "
                  f"{b['tile'][0]}x{b['tile'][1]}, K {k}"),
        "ms": mean(xbig["times_ms"]["B 2 rows"]), "ms_turns": xbig["times_ms"],
        "device_us": b["profile"]["device_us_per_step"],
        "plain_ms": mean(xbig["plain_ms_runs"]), "bound_ms": bound, "bound_by": bound_by,
        "bound_ms_inplace_bytes": (fn_bytes + 2 * 4 * b["band_floats"] / k)
                                  / MEM_BYTES_PER_S * 1e3,
        "library_ms": None, "peak_bytes": xbig["peak_bytes"], "f_bytes": xbig["f_bytes"],
        "card": card})
    for mode in ("noop", "stream", "collide"):
        name = f"lbm_ablate_{mode}"
        r = arec["kernels"][name]
        by, bx, k = r["tile"]
        bound, bound_by = _bound_ms(BYTES_PER_CELL * r["cells"] / k,
                                    OPS_PER_UPDATE * r["cells"] if mode == "collide" else 0)
        out.append({
            "name": name, "route": "cuda", "source": "lbm_tpu_torch/csrc/lbm_ablate.cu",
            "replaces": "tools/ablate_step.py:48", "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "errors_by_shape": r["by_shape"],
            "per": "step", "shape": f"1024x1024, tile {by}x{bx}, K {k}",
            "ms": mean(r["ms_runs"]), "ms_runs": r["ms_runs"],
            "tool_us_per_step": r["tool_us_per_step"], "plain_ms": mean(r["plain_ms_runs"]),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None, "card": card})
    for mix in ("add", "fma", "mix"):
        name = f"lbm_roofline_{mix}"
        r = rrec["kernels"][name]
        bound, bound_by = _bound_ms(r["bytes"], r["ops"])
        out.append({
            "name": name, "route": "cuda", "source": "lbm_tpu_torch/csrc/lbm_roofline.cu",
            "replaces": "tools/vpu_roofline.py:58", "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "per": "launch", "shape": "16896x128, inner 200, unroll 64",
            "ms": mean(r["ms_runs"]), "ms_runs": r["ms_runs"],
            "plain_ms": mean(r["plain_ms_runs"]), "bound_ms": bound, "bound_by": bound_by,
            "Gissue_per_s": rrec["rates"][mix]["Gissue_per_s"], "library_ms": None,
            "card": card})
    return out


def _temporal16_entry(launches, t16, tune, card) -> dict:
    """The kernels-line entry of the 16-bit kernel: its time a step at
    1024^2 (float16) by ``fp16_experiment time`` from the uniform state
    (``ms``, the measure of every earlier run; bfloat16, fp32 and 4096^2
    of the same calls beside it), and phase 10's turns against the fp32
    kernel from one developed state (``ms_turns``); its plain version's;
    its bound: 37/K bytes an update (9 16-bit populations in and out, the
    mask byte in) or its operations."""
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    turns = {grid: {name.split(" ", 1)[1]: mean(ms) for name, ms in t["times_ms"].items()}
             for grid, t in t16["turns"].items()}
    t1024 = t16["turns"]["1024x1024"]
    r16 = tune["times"]["1024x1024"]["float16"]
    own = t16["times"]
    return {
        "name": "lbm_temporal16_step", "route": "cuda",
        "source": "lbm_tpu_torch/csrc/lbm_temporal16.cu",
        "replaces": "lbm_tpu/ops/fused.py:799 (storage=float16/bfloat16)",
        "launches": launches["lbm_temporal16_step"],
        "max_abs_err": t16["max_abs_err"], "max_ulps": t16["max_ulps"],
        "max_av_rtol": t16["max_av_rtol"], "av_rtol_1000_steps": t16["max_av_rtol_1000"],
        "errors_by_shape": t16["by_shape"], "per": "step",
        "shape": f"1024x1024, tile {r16['by']}x{r16['bx']}, K {r16['k']}, uniform start",
        "ms": r16["us_per_step"] / 1e3,
        "ms_timer_uniform_start": {grid: {n: r["us_per_step"] / 1e3 for n, r in rows.items()}
                                   for grid, rows in tune["times"].items()},
        "shape_turns": (f"tile {t1024['tile'][0]}x{t1024['tile'][1]}, K "
                        f"{t1024['tile'][2]}, after {t1024['developed_steps']} steps of "
                        "flow at 1024x1024"),
        "ms_turns": turns,
        "turns_developed": t16["turns"],
        "plain_ms": mean(own["float16"]["plain_ms_runs"]),
        "plain_ms_bfloat16": mean(own["bfloat16"]["plain_ms_runs"]),
        "bound_ms": r16["bound_ms"], "bound_by": r16["bound_by"], "library_ms": None,
        "card": card,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    with phase("1 environment"):
        card = phase_env(torch)
    with phase("2 build"):
        resources = phase_build()
    with phase("3 kernels vs plain torch, and times"):
        frec = phase_fused(torch, card)
        mrec = phase_multi(torch, card, seed0=len(ODD_SHAPES) + len(CASES))
        trec = phase_temporal(torch, card, seed0=2 * len(ODD_SHAPES) + len(CASES)
                              + len(SMALL_CASES))
        irec = phase_inplace(torch, card, seed0=2 * len(ODD_SHAPES) + len(CASES)
                             + len(SMALL_CASES) + 1 + len(TEMPORAL_SMALL))
        timing = phase_timing(torch, card)
        ctiming = phase_cluster_timing(torch, card)
        itiming = phase_inplace_timing(torch, card)
        copy_gbs = phase_copy_bandwidth(torch, card)
        l2_gbs = phase_l2_copy(torch, card)
    with phase("4 main path: four canonical cases, the one-step branch, --kernel mega "
               "and a checkpointed run through the CLI; the 1024^2 run's split and its "
               "final_state against the fp64 engine"):
        main_rec = phase_main(torch, card)
        split = phase_split(torch, card)
        fp64 = phase_fp64(torch, card, main_rec)
    with phase("5 giant grids: validate_giant kernel, fields and ckpt"):
        giant = phase_giant(torch, card)
    with phase("6 reproducibility; the debugging scopes"):
        phase_repro()
        phase_debugging(torch, card)
    with phase("7 sharded: shard kernels vs plain torch, sharded vs single-device runs, "
               "4096^2 on one card, the sharded CLI"):
        skrec = phase_sharded_kernels(torch, card, seed0=2 * len(ODD_SHAPES) + len(CASES)
                                      + len(SMALL_CASES) + 2 + len(TEMPORAL_SMALL)
                                      + len(INPLACE_SMALL) + len(INPLACE_PREFETCH))
        seq = phase_sharded_equality(torch, card, seed=100)
        sbig = phase_sharded_big(torch, card)
        scli = phase_sharded_cli(torch, card)
    seed8 = (2 * len(ODD_SHAPES) + len(CASES) + len(SMALL_CASES) + 2 + len(TEMPORAL_SMALL)
             + len(INPLACE_SMALL) + len(INPLACE_PREFETCH) + len(SHARD_SHAPES)
             + len(SHARD_CLI))
    with phase("8 the sharded x-tiled route: its kernel vs plain torch, 8192^2 over 2 and "
               "4 rows and 2x1, the CLI"):
        xkrec = phase_shard_xt_kernels(torch, card, seed0=seed8)
        xbig = phase_shard_xt_big(torch, card)
        xcli = phase_shard_xt_cli(torch, card)
    with phase("9 the study tools: ablation and roofline kernels vs plain torch, the "
               "1024^2 attribution and the issue rates"):
        arec = phase_ablation(torch, card, seed0=seed8 + len(XT_SHARD_SHAPES)
                              + len(XT_SHARD_PREFETCH) + 1)
        rrec = phase_roofline(torch, card)
    issue_rate = rrec["rates"]["mix"]["Gissue_per_s"] * 1e9
    seed10 = seed8 + len(XT_SHARD_SHAPES) + len(XT_SHARD_PREFETCH) + 1 + len(ABLATE_SHAPES)
    with phase("10 the tuning path: the 16-bit kernel vs plain torch, fp16_experiment "
               "time and drift, lbm autotune and its cache"):
        t16 = phase_temporal16(torch, card, seed0=seed10)
        tune = phase_tuning(torch, card, issue_rate, seed=seed10 + len(TEMPORAL16_SHAPES))
    with phase("11 the self-contained gate: check_self on the four cases, bench_all"):
        gate = phase_gate(torch, card)
    with phase("12 a mesh over two processes on this card, card to card over CUDA IPC: "
               "the exchange kernels vs plain torch, multihost_smoke at 1024^2 over three "
               "meshes, one shard kernel each, and at 4096^2 over 2 x 4 rows"):
        xrec = phase_exchange_kernels(torch, card)
        mh = phase_multihost(card)

    from lbm_tpu_torch.config import CANONICAL_PARAMS
    from lbm_tpu_torch.ops.fused import window_bytes_per_update
    from lbm_tpu_torch.utils.profiling import BYTES_PER_CELL

    launches = {name: sum(r["launches"][name] for r in (main_rec, giant, sbig, scli, xbig,
                                                        xcli, arec, rrec, tune, gate, mh))
                for name in main_rec["launches"]}
    # The multi-step kernels the route gives none of the main path's grids
    # (phase 3 holds and times them all).
    off_path = {LAUNCH_NAMES[r] for r in LAUNCH_NAMES} - {
        _multi_kernel(*CANONICAL_PARAMS[c].shape) for c in SMALL_CASES}
    require(all(v > 0 for name, v in launches.items() if name not in off_path),
            f"a kernel of the main path never launched: {launches}")
    require(all(launches[name] == 0 for name in off_path),
            f"a multi-step kernel off the route launched on the main path: {launches}")
    big, small = frec["timing"]["1024x1024"], frec["timing"]["128x128"]
    t128, t1024 = timing["128x128"], timing["1024x1024"]
    by, bx, k = t1024["chosen"]
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    cells_big, cells_small = 1024 * 1024, 128 * 128
    t_names = list(t1024["times_ms"])
    m_names = list(t128["times_ms"])
    crec, c128 = mrec["lbm_multi_cluster_step"], ctiming["grids"]["128x128"]
    brec, c256 = mrec["lbm_multi_bands_step"], ctiming["grids"]["256x256"]
    c_names = list(c128["times_ms"])

    fused_bound, fused_by = _bound_ms(BYTES_PER_CELL * cells_big,
                                      OPS_PER_UPDATE * cells_big)
    chunk = t128["chunk"]
    multi_bound, multi_by = _bound_ms(BYTES_PER_CELL * cells_small / chunk,
                                      OPS_PER_UPDATE * cells_small)
    bands_bound, bands_by = _bound_ms(BYTES_PER_CELL * 256 * 256 / c256["chunk"],
                                      OPS_PER_UPDATE * 256 * 256)
    temp_bound, temp_by = _bound_ms(BYTES_PER_CELL * cells_big / k,
                                    OPS_PER_UPDATE * cells_big)
    window_b = window_bytes_per_update(by, bx, k) * cells_big
    xt_t = itiming["8192x8192"]
    xt_names = list(xt_t["times_ms"])
    xt_k = xt_t["tile"][2]
    mg_t = itiming["1024x1024"]
    mg_names = list(mg_t["times_ms"])
    mg_by, mg_bx, mg_k, mg_tp = mg_t["mega"]
    kernels = {"kernels": [
        {
            "name": "lbm_fused_step",
            "route": "cuda",
            "source": "lbm_tpu_torch/csrc/lbm_step.cu",
            "replaces": "lbm_tpu/ops/fused.py:361",
            "also_replaces": ["lbm_tpu/ops/fused.py:347"],
            "launches": launches["lbm_fused_step"],
            "max_abs_err": frec["max_abs_err"],
            "max_abs_err_1000_steps": frec["max_abs_err_1000"],
            "av_rtol_1000_steps": frec["av_rtol_1000"],
            "errors_by_shape": frec["by_shape"],
            "per": "step",
            "shape": "1024x1024",
            "ms": big["ms"],
            "plain_ms": big["plain_ms"],
            "bound_ms": fused_bound,
            "bound_by": fused_by,
            "bound_ms_at_copy_rate": BYTES_PER_CELL * cells_big / (copy_gbs * 1e9) * 1e3,
            "library_ms": None,
            "ms_turns_1024x1024": t1024["times_ms"][t_names[0]],
            "ms_turns_8192x8192": xt_t["times_ms"][xt_names[2]],
            "device_us_8192x8192": xt_t["profiles"][xt_names[2]]["device_us"],
            "ms_128x128": small["ms"],
            "plain_ms_128x128": small["plain_ms"],
            "checked_ms_128x128": mean(small["checked_ms_runs"]),
            "device_us_1024x1024": big["kernel_profile"]["device_us"],
            "device_us_128x128": small["kernel_profile"]["device_us"],
            "plain_device_us_1024x1024": big["plain_profile"]["device_us"],
            "device_gbs_1024x1024": big["device_gbs_at_73B"],
            "graph_ms_128x128": mean(t128["times_ms"][m_names[2]]),
            "graph_device_us_128x128": t128["profiles"][m_names[2]]["device_us"],
            "card": card,
        },
        {
            "name": "lbm_multi_step",
            "route": "cuda",
            "source": "lbm_tpu_torch/csrc/lbm_multi.cu",
            "replaces": "lbm_tpu/ops/fused.py:565",
            "launches": launches["lbm_multi_step"],
            "max_abs_err": mrec["lbm_multi_step"]["max_abs_err"],
            "max_abs_err_1000_steps": mrec["lbm_multi_step"]["max_abs_err_1000"],
            "av_rtol_1000_steps": mrec["lbm_multi_step"]["av_rtol_1000"],
            "errors_by_shape": mrec["lbm_multi_step"]["by_shape"],
            "per": "step",
            "shape": f"128x128, chunk {chunk}",
            "ms": mean(t128["times_ms"][m_names[1]]),
            "ms_turns": t128["times_ms"][m_names[1]],
            "device_us": t128["profiles"][m_names[1]]["device_us"],
            "plain_ms": mean(t128["plain_multi_ms_runs"]),
            "bound_ms": multi_bound,
            "bound_by": multi_by,
            "bound_ms_l2": BYTES_PER_CELL * cells_small / (l2_gbs * 1e9) * 1e3,
            "library_ms": None,
            "one_step_loop_ms_turns": t128["times_ms"][m_names[0]],
            "blocks": t128["multi_blocks"],
            "ms_by_grid_against_cluster": {case: mean(g["times_ms"][c_names[0]])
                                           for case, g in ctiming["grids"].items()},
            "card": card,
        },
        {
            "name": "lbm_multi_cluster_step",
            "route": "cuda",
            "source": "lbm_tpu_torch/csrc/lbm_multi_cluster.cu",
            "replaces": "lbm_tpu/ops/fused.py:565",
            "launches": launches["lbm_multi_cluster_step"],
            "max_abs_err": crec["max_abs_err"],
            "max_av_rtol": crec["max_av_rtol"],
            "max_av_rtol_against_lbm_multi_step": crec["max_av_rtol_grid"],
            "max_abs_err_1000_steps": crec["max_abs_err_1000"],
            "av_rtol_1000_steps": crec["av_rtol_1000"],
            "errors_by_shape": crec["by_shape"],
            "per": "step",
            "shape": f"128x128, chunk {c128['chunk']}, a cluster of {c128['cluster']} blocks",
            "ms": mean(c128["times_ms"][c_names[1]]),
            "ms_turns": c128["times_ms"][c_names[1]],
            "device_us": c128["profiles"][c_names[1]]["device_us"],
            "ms_by_grid": {case: mean(g["times_ms"][c_names[1]])
                           for case, g in ctiming["grids"].items()},
            "lbm_multi_step_ms_by_grid": {case: mean(g["times_ms"][c_names[0]])
                                          for case, g in ctiming["grids"].items()},
            "route_by_grid": {case: g["route"] for case, g in ctiming["grids"].items()},
            "smem_bytes_by_grid": {case: g["smem_bytes"]
                                   for case, g in ctiming["grids"].items()},
            "plain_ms": mean(c128["plain_ms_runs"]),
            "bound_ms": multi_bound,
            "bound_by": multi_by,
            "bound_ms_l2": BYTES_PER_CELL * cells_small / (l2_gbs * 1e9) * 1e3,
            "library_ms": None,
            "cluster": c128["cluster"],
            "admission": ctiming["admission"],
            "barrier_us": ctiming["barrier_us"],
            "card": card,
        },
        {
            "name": "lbm_multi_bands_step",
            "route": "cuda",
            "source": "lbm_tpu_torch/csrc/lbm_multi_bands.cu",
            "replaces": "lbm_tpu/ops/fused.py:565",
            "launches": launches["lbm_multi_bands_step"],
            "max_abs_err": brec["max_abs_err"],
            "max_av_rtol": brec["max_av_rtol"],
            "max_av_rtol_against_lbm_multi_step": brec["max_av_rtol_grid"],
            "max_abs_err_1000_steps": brec["max_abs_err_1000"],
            "av_rtol_1000_steps": brec["av_rtol_1000"],
            "errors_by_shape": brec["by_shape"],
            "per": "step",
            "shape": f"256x256, chunk {c256['chunk']}, {c256['bands_blocks']} blocks of "
                     f"{c256['bands_threads']} threads",
            "ms": mean(c256["times_ms"][c_names[2]]),
            "ms_turns": c256["times_ms"][c_names[2]],
            "device_us": c256["profiles"][c_names[2]]["device_us"],
            "ms_by_grid": {case: mean(g["times_ms"][c_names[2]])
                           for case, g in ctiming["grids"].items()},
            "ms_turns_by_grid": {case: g["times_ms"] for case, g in ctiming["grids"].items()},
            "route_by_grid": {case: g["route"] for case, g in ctiming["grids"].items()},
            "blocks_threads_smem_by_grid": {
                case: [g["bands_blocks"], g["bands_threads"], g["bands_smem_bytes"]]
                for case, g in ctiming["grids"].items()},
            "plain_ms": mean(c256["plain_ms_runs"]),
            "bound_ms": bands_bound,
            "bound_by": bands_by,
            "library_ms": None,
            "handoff_us": {k: v for k, v in ctiming["barrier_us"].items()
                           if k.startswith("handoff")},
            "bands_admission": ctiming["bands_admission"],
            "cooperative_cluster_launch": ctiming["cooperative_cluster_launch"],
            "card": card,
        },
        {
            "name": "lbm_temporal_step",
            "route": "cuda",
            "source": "lbm_tpu_torch/csrc/lbm_temporal.cu",
            "replaces": "lbm_tpu/ops/fused.py:799",
            "launches": launches["lbm_temporal_step"],
            "max_abs_err": trec["max_abs_err"],
            "max_abs_err_1000_steps": trec["max_abs_err_1000"],
            "av_rtol_1000_steps": trec["av_rtol_1000"],
            "errors_by_shape": trec["by_shape"],
            "per": "step",
            "shape": f"1024x1024, tile {by}x{bx}, K {k}",
            "ms": mean(t1024["times_ms"][t_names[1]]),
            "ms_turns": t1024["times_ms"][t_names[1]],
            "device_us": t1024["profiles"][t_names[1]]["device_us"],
            "other_k": {"name": t_names[2], "ms_turns": t1024["times_ms"][t_names[2]],
                        "device_us": t1024["profiles"][t_names[2]]["device_us"]},
            "ms_turns_against_mega": mg_t["times_ms"][mg_names[1]],
            "ms_turns_8192x8192": xt_t["times_ms"][xt_names[1]],
            "device_us_8192x8192": xt_t["profiles"][xt_names[1]]["device_us"],
            "plain_ms": mean(t1024["plain_temporal_ms_runs"]),
            "bound_ms": temp_bound,
            "bound_by": temp_by,
            "bound_ms_window_bytes": window_b / MEM_BYTES_PER_S * 1e3,
            "library_ms": None,
            "card": card,
        },
        _inplace_entry(
            "lbm_temporal_xt_step", "lbm_tpu_torch/csrc/lbm_temporal_xt.cu",
            "lbm_tpu/ops/fused.py:1075", launches["lbm_temporal_xt_step"],
            irec["lbm_temporal_xt_step"], xt_t["times_ms"], xt_names[0],
            xt_t["profiles"][xt_names[0]], xt_t["plain_xt_ms_runs"], xt_k,
            xt_t["band_floats"], xt_t["cells"], card,
            shape=f"8192x8192, tile {xt_t['tile'][0]}x{xt_t['tile'][1]}, K {xt_k}",
            peak_bytes_8192x8192=xt_t["peak_bytes"], f_bytes_8192x8192=xt_t["f_bytes"],
            validate_giant={n: {key: r[key] for key in ("us_per_step", "glups")}
                            for n, r in giant["kernel"].items()}),
        _inplace_entry(
            "lbm_mega_step", "lbm_tpu_torch/csrc/lbm_temporal_xt.cu",
            "lbm_tpu/ops/fused.py:1767", launches["lbm_mega_step"],
            irec["lbm_mega_step"], mg_t["times_ms"], mg_names[0],
            mg_t["profiles"][mg_names[0]], mg_t["plain_mega_ms_runs"], mg_k * mg_tp,
            mg_t["band_floats"], mg_t["cells"], card,
            shape=f"1024x1024, tile {mg_by}x{mg_bx}, K {mg_k}, T {mg_tp}",
            blocks=mg_t["blocks"],
            temporal_ms_turns=mg_t["times_ms"][mg_names[1]],
            xtiled_ms_turns=mg_t["times_ms"][mg_names[2]],
            xtiled_device_us=mg_t["profiles"][mg_names[2]]["device_us"],
            bitwise_xtiled_launches=irec["lbm_mega_step"]["bitwise_xtiled_launches_1024"]),
        _shard_entry("lbm_shard_step", "lbm_tpu_torch/csrc/lbm_shard.cu",
                     "lbm_tpu/ops/fused.py:385", launches["lbm_shard_step"],
                     skrec["lbm_shard_step"], sbig, card),
        _shard_entry("lbm_shard_temporal_step", "lbm_tpu_torch/csrc/lbm_temporal.cu",
                     "lbm_tpu/ops/fused.py:799", launches["lbm_shard_temporal_step"],
                     skrec["lbm_shard_temporal_step"], sbig, card),
    ], "copy_gbs": copy_gbs, "l2_copy_gbs": l2_gbs, "cases": main_rec["cases"],
        "sharded": {"equality_1024": seq, "cases": scli["cases"],
                    "big": {name: {key: r.get(key) for key in (
                        "us_per_step", "mlups", "elapsed_s", "variant", "chunk",
                        "launches", "f_bitwise_single", "av_rel_single", "profile")} for name, r in sbig["runs"].items()}},
        "split_1024x1024": split, "fp64_1024x1024": fp64,
        "gate": {key: gate[key] for key in ("check_self", "bench_all")},
        "giant": {"fields": {n: {key: r.get(key) for key in ("elapsed_s", "wall_s", "mlups",
                                                             "split")}
                             for n, r in giant["fields"].items()},
                  "ckpt": giant["ckpt"]}}
    kernels["kernels"] += _new_entries(launches, xkrec, xbig, arec, rrec, card)
    kernels["kernels"].append(_temporal16_entry(launches, t16, tune, card))
    # The exchange kernels, on the messages of phase 12's runs; the main
    # figures at configs[4]'s (the largest), every message's beside them.
    for name in EXCHANGE_KERNELS:
        by_message = xrec[name]["by_message"]
        main_label = max(by_message, key=lambda k: by_message[k]["bytes"])
        m = by_message[main_label]
        kernels["kernels"].append({
            "name": name, "route": "cuda", "source": "lbm_tpu_torch/csrc/lbm_ipc.cu",
            "replaces": "no Pallas kernel: lax.ppermute's transfer between processes, "
                        "lbm_tpu/parallel/sharded.py:89-95, 310-320, 626-627, 1118-1123",
            "launches": launches[name], "max_abs_err": 0.0, "per": "launch",
            "shape": f"{main_label}: {m['pieces']} pieces {m['shapes']}",
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "library": "torch._foreach_copy_", "by_message": by_message, "card": card})
    # The shard kernels in phase 12's two-process runs: held against their
    # plain versions there too, and their times beside the same mesh's in
    # one process.
    for e in kernels["kernels"]:
        runs = {label: run for label, run in mh["runs"].items()
                if run["kernel_name"] == e["name"]}
        for run in runs.values():
            e["max_abs_err"] = max(e["max_abs_err"], run["max_abs_err"])
        if runs:
            e["two_process"] = {label: {key: run[key] for key in (
                "mesh", "variant", "chunk", "transport", "launches", "us_per_step",
                "us_per_step_one_process", "exchange_us", "exchange", "launch_us",
                "exchange_share_of_launch", "pieces", "send_channels", "message_bytes",
                "message_us", "max_abs_err", "max_av_rtol", "wall_s")}
                for label, run in runs.items()}
    # The issue bound beside every bound_ms: the fp32 operations the
    # function needs (104 a cell update; none for the ablation's data
    # movers; the probe's own for the roofline kernels) at the measured
    # rate of the mix blend.  A floor: the shared-memory, index and barrier
    # instructions a kernel also issues are not counted (nor, for the
    # 16-bit kernel, its 18 conversions an update).
    cells = {"lbm_fused_step": cells_big, "lbm_multi_step": cells_small,
             "lbm_multi_cluster_step": cells_small, "lbm_multi_bands_step": 256 * 256,
             "lbm_temporal_step": cells_big, "lbm_temporal_xt_step": xt_t["cells"],
             "lbm_mega_step": mg_t["cells"], "lbm_shard_step": SHARD_BIG**2,
             "lbm_shard_temporal_step": SHARD_BIG**2,
             "lbm_shard_temporal_xt_step": xbig["cells"],
             "lbm_ablate_noop": 0, "lbm_ablate_stream": 0,
             "lbm_ablate_collide": arec["kernels"]["lbm_ablate_collide"]["cells"],
             "lbm_temporal16_step": cells_big,
             **dict.fromkeys(EXCHANGE_KERNELS, 0)}
    for e in kernels["kernels"]:
        ops = (rrec["kernels"][e["name"]]["ops"] if e["name"] in rrec["kernels"]
               else OPS_PER_UPDATE * cells[e["name"]])
        e["bound_ms_issue"] = ops / issue_rate * 1e3
        print(f"kernel {e['name']}: {e['ms']} ms a {e['per']}; bound_ms {e['bound_ms']} "
              f"({e['bound_by']}), bound_ms_issue {e['bound_ms_issue']}; plain "
              f"{e['plain_ms']} ms; launches {e['launches']} | {card}")
    for e in kernels["kernels"]:
        if e["name"] in off_path:
            e["off_main_path"] = True
    kernels.update(
        issue_rate_per_s=issue_rate, resources=resources,
        roofline=rrec["rates"], ablation={"modes": arec["modes"],
                                          "attribution": arec["attribution"]},
        sharded_xt={"big": {key: {k: r.get(k) for k in (
            "elapsed_s", "launches", "f_bitwise_single", "av_rel_single", "slab", "tile",
            "k", "shards", "profile")} for key, r in xbig["runs"].items()},
            "times_ms": xbig["times_ms"], "peak_bytes": xbig["peak_bytes"],
            "f_bytes": xbig["f_bytes"], "cli": xcli["cases"]},
        tuning={key: tune[key] for key in ("times", "drift", "autotune", "cases")},
        multihost={"compute_mode": mh["compute_mode"], "mps": mh["mps"],
                   "runs": mh["runs"]})
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
