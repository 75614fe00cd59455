"""D2Q9 lattice constants (numpy only; the same values as ``lbm_tpu``).

Velocity numbering follows the reference diagram (``d2q9-bgk.c:7-13``)::

    6 2 5
    3 0 1
    7 4 8

with +x east (the fastest-varying index) and +y north (the row index).
"""

from __future__ import annotations

import numpy as np

NSPEEDS = 9

# Velocity components e_k (x and y) per speed.
CX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1], dtype=np.int32)
CY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1], dtype=np.int32)

# Bounce-back partner: column 0 of the reference's branchless rebound lookup
# table (``kernels.cl:69``) — an involution mapping each speed to its
# opposite direction.
OPPOSITE = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)

# BGK equilibrium weights w0=4/9, w1=1/9, w2=1/36 (``kernels.cl:65-67``).
WEIGHTS = np.array(
    [4.0 / 9.0] + [1.0 / 9.0] * 4 + [1.0 / 36.0] * 4, dtype=np.float32
)

# Speeds with positive/negative x-projection (for momentum and body force).
EAST_SPEEDS = (1, 5, 8)
WEST_SPEEDS = (3, 6, 7)
NORTH_SPEEDS = (2, 5, 6)
SOUTH_SPEEDS = (4, 7, 8)

# Body-force kick (reference accelerate_flow, ``kernels.cl:35-42``): add
# w1/w2 to the east-pointing speeds, subtract from the west-pointing ones;
# axis speeds (1, 3) use weight w1 = rho*a/9, diagonals use w2 = rho*a/36.
# The SINGLE definition — every kernel/path derives its kick from this.
KICK_SIGNS = {1: 1.0, 5: 1.0, 8: 1.0, 3: -1.0, 6: -1.0, 7: -1.0}
KICK_AXIS_SPEEDS = (1, 3)  # these take w1; the rest of KICK_SIGNS take w2


def kick_scale(k: int, w1, w2):
    """Signed kick increment for speed ``k`` (None for unkicked speeds)."""
    if k not in KICK_SIGNS:
        return None
    return KICK_SIGNS[k] * (w1 if k in KICK_AXIS_SPEEDS else w2)


def sanity() -> None:
    """Internal consistency checks (used by tests)."""
    assert (CX[list(EAST_SPEEDS)] == 1).all()
    assert (CX[list(WEST_SPEEDS)] == -1).all()
    assert (CY[list(NORTH_SPEEDS)] == 1).all()
    assert (CY[list(SOUTH_SPEEDS)] == -1).all()
    assert (CX[OPPOSITE] == -CX).all() and (CY[OPPOSITE] == -CY).all()
    assert (OPPOSITE[OPPOSITE] == np.arange(NSPEEDS)).all()
    np.testing.assert_allclose(WEIGHTS.sum(), 1.0, rtol=1e-6)
