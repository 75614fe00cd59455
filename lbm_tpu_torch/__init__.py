"""lbm_tpu_torch — the D2Q9-BGK lattice-Boltzmann engine on PyTorch + CUDA.

The port of ``lbm_tpu`` to an NVIDIA H100: the same file contracts
(``.params`` / obstacle ``.dat`` in, ``av_vels.dat`` / ``final_state.dat``
out, the same 1% checker), the same public names on a single device, and
each Pallas kernel of the path rewritten by hand in CUDA for Hopper
(``csrc/``).  Imports torch and numpy, never JAX; ``lbm_tpu`` stays the
reference it is tested against.
"""

# The import of the package is a set-up stage of its own (setup.import,
# recorded with or without a profiler: utils/profiling.py).
from lbm_tpu_torch.utils import profiling as _profiling

with _profiling.span("setup.import", always=True):
    from lbm_tpu_torch.config import CANONICAL_PARAMS, LBMParams
    from lbm_tpu_torch.diagnostics import av_velocity, calc_reynolds, total_density
    from lbm_tpu_torch.geometry import (
        canonical_obstacles,
        channel_box,
        free_cells_of,
        load_obstacle_file,
        write_obstacle_file,
    )
    from lbm_tpu_torch.io import (
        read_av_vels,
        read_final_state,
        write_av_vels,
        write_final_state,
    )
    from lbm_tpu_torch.parallel.mesh import default_mesh, default_mesh_2d
    from lbm_tpu_torch.parallel.sharded import ShardedSimulator
    from lbm_tpu_torch.runtime import (
        RunResult,
        Simulator,
        hbm_budget_gib,
        select_device,
        state_readback_fits,
    )

__version__ = "0.1.0"

# lbm_tpu's names, but enable_compile_cache: it switches on JAX's
# persistent compile cache, and the port's counterpart needs no switch
# (the kernel library in build/lbm_tpu_torch/ is kept, named by a hash of
# its sources, ops/_build.py).
__all__ = [
    "CANONICAL_PARAMS",
    "LBMParams",
    "RunResult",
    "ShardedSimulator",
    "Simulator",
    "av_velocity",
    "calc_reynolds",
    "canonical_obstacles",
    "channel_box",
    "default_mesh",
    "default_mesh_2d",
    "free_cells_of",
    "hbm_budget_gib",
    "load_obstacle_file",
    "read_av_vels",
    "read_final_state",
    "select_device",
    "state_readback_fits",
    "total_density",
    "write_av_vels",
    "write_final_state",
    "write_obstacle_file",
]
