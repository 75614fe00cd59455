"""Run configuration for the D2Q9-BGK lattice-Boltzmann engine.

Parity target: the 7-line ``.params`` text format consumed by the reference
host program (``d2q9-bgk.c:466-492``): ``nx, ny, maxIters, reynolds_dim,
density, accel, omega`` — one value per line, in that order.  The same
contract as ``lbm_tpu.config``, in plain Python so that the port runs
where JAX is absent.
"""

from __future__ import annotations

import dataclasses
import pathlib


@dataclasses.dataclass(frozen=True)
class LBMParams:
    """Static parameters of one simulation (reference ``t_param``)."""

    nx: int
    ny: int
    max_iters: int
    reynolds_dim: int
    density: float
    accel: float
    omega: float

    def __post_init__(self) -> None:
        if self.nx <= 0 or self.ny <= 0:
            raise ValueError(f"grid must be positive, got {self.nx}x{self.ny}")
        if self.ny < 2:
            # The body force applies at row ny-2 (d2q9-bgk.c / kernels.cl);
            # ny=1 would silently wrap it to row -1 via negative indexing.
            raise ValueError(f"need ny >= 2 for the body-force row, got {self.ny}")
        if self.max_iters < 0:
            raise ValueError(f"max_iters must be >= 0, got {self.max_iters}")
        if not 0.0 < self.omega < 2.0:
            # BGK stability bound; omega >= 2 also makes nu <= 0 and the
            # Reynolds epilogue divide by zero.
            raise ValueError(f"omega must be in (0, 2), got {self.omega}")
        if self.density <= 0.0:
            raise ValueError(f"density must be positive, got {self.density}")

    @property
    def viscosity(self) -> float:
        """Kinematic viscosity nu = (2/omega - 1)/6 (``d2q9-bgk.c:750``)."""
        return 1.0 / 6.0 * (2.0 / self.omega - 1.0)

    @property
    def shape(self) -> tuple[int, int]:
        """(ny, nx) row-major grid shape."""
        return (self.ny, self.nx)

    @classmethod
    def from_file(cls, path: str | pathlib.Path) -> "LBMParams":
        """Load the reference 7-line ``.params`` format."""
        text = pathlib.Path(path).read_text()
        fields = text.split()
        if len(fields) != 7:
            raise ValueError(
                f"params file {path} needs exactly 7 whitespace-separated "
                f"values, got {len(fields)}"
            )
        nx, ny, max_iters, reynolds_dim = (int(v) for v in fields[:4])
        density, accel, omega = (float(v) for v in fields[4:7])
        return cls(nx, ny, max_iters, reynolds_dim, density, accel, omega)

    def to_file(self, path: str | pathlib.Path) -> None:
        """Write the 7-line ``.params`` format (round-trips ``from_file``)."""
        lines = [
            str(self.nx),
            str(self.ny),
            str(self.max_iters),
            str(self.reynolds_dim),
            format_param_float(self.density),
            format_param_float(self.accel),
            format_param_float(self.omega),
        ]
        pathlib.Path(path).write_text("\n".join(lines) + "\n")


def format_param_float(v: float) -> str:
    """Compact decimal form used by the shipped ``input_*.params`` files.

    ``repr`` is the shortest string that round-trips the float exactly —
    for the canonical values it matches the shipped files ('0.1',
    '0.005'), and unlike ``%g`` (6 significant digits) it never silently
    truncates a higher-precision value on ``to_file``."""
    return repr(v)


# The four canonical cases shipped with the reference (``input_*.params``).
CANONICAL_PARAMS: dict[str, LBMParams] = {
    "128x128": LBMParams(128, 128, 40000, 10, 0.1, 0.005, 1.85),
    "128x256": LBMParams(128, 256, 40000, 10, 0.1, 0.005, 1.85),
    "256x256": LBMParams(256, 256, 80000, 10, 0.1, 0.005, 1.85),
    "1024x1024": LBMParams(1024, 1024, 20000, 10, 0.1, 0.01, 1.85),
}
