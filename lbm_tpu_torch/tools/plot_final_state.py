"""Render final_state.dat as a velocity-magnitude heatmap PNG (the port of
``tools/plot_final_state.py``).

The matplotlib analog of the reference's gnuplot script: plot columns
1:2:5 (x, y, |u|) as an image.  Where matplotlib is missing it says so and
exits 1.

    python -m lbm_tpu_torch.tools.plot_final_state final_state.dat [out.png]
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv: list[str]) -> int:
    if not 1 <= len(argv) <= 2:
        print("usage: plot_final_state.py <final_state.dat> [out.png]", file=sys.stderr)
        return 2
    src = argv[0]
    dst = argv[1] if len(argv) > 1 else "final_state.png"
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available in this environment", file=sys.stderr)
        return 1

    data = np.loadtxt(src, usecols=[0, 1, 4])
    nx = int(data[:, 0].max()) + 1
    ny = int(data[:, 1].max()) + 1
    speed = data[:, 2].reshape(ny, nx)

    fig, ax = plt.subplots(figsize=(8, 8 * ny / nx))
    im = ax.imshow(speed, origin="lower", cmap="viridis", aspect="equal")
    fig.colorbar(im, ax=ax, label="|u|")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_title("velocity magnitude")
    fig.savefig(dst, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {dst} ({nx}x{ny})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
