"""Plain reference of the D2Q9-BGK solver of the University of Bristol HPC
coursework (``d2q9-bgk.c`` and ``kernels.cl`` of
https://github.com/ag14774/OpenCL-Lattice-Boltzmann), written from that
algorithm in plain torch.  It imports nothing of the program under test.

A step, on ``f[B, 9, ny, nx]`` (speeds numbered 6 2 5 / 3 0 1 / 7 4 8, +x
east along a row, +y north across rows):

1. accelerate_flow: on row ny-2, every fluid cell whose populations 3, 6
   and 7 stay positive after the kick gains w1 = density*accel/9 on speed
   1 and w2 = density*accel/36 on 5 and 8, and loses them on 3, 6 and 7;
2. propagate: ``t[k][y, x] = f[k][y - cy_k, x - cx_k]``, periodic in both
   axes;
3. rebound on obstacle cells (``f'[k] = t[opposite k]``) and BGK collision
   on fluid cells (``f'[k] = t[k] + omega (feq[k] - t[k])``, ``feq[k] = w_k
   rho (1 + 3 c.u + 4.5 (c.u)^2 - 1.5 u.u)``);
4. av_velocity: the mean of |u| over the fluid cells, u from ``t``.

``dtype`` is the working precision of the state and of every operation:
float32 is the precision the configuration states; bfloat16 is the
lower-precision control.  On a CUDA device the steps run as replays of a
CUDA graph of up to 200 steps, so that the check takes seconds.
"""

from __future__ import annotations

import numpy as np
import torch

CX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
CY = (0, 0, 1, 0, -1, 1, 1, -1, -1)
OPPOSITE = (0, 3, 4, 1, 2, 7, 8, 5, 6)
WEIGHTS = (4.0 / 9.0,) + (1.0 / 9.0,) * 4 + (1.0 / 36.0,) * 4
GRAPH_STEPS = 200


def uniform(params: dict, device) -> torch.Tensor:
    """The uniform initial state ``w_k * density``, ``[9, ny, nx]`` float32."""
    w = torch.tensor(WEIGHTS, dtype=torch.float64) * params["density"]
    return (w.to(torch.float32).to(device)[:, None, None]
            .expand(9, params["ny"], params["nx"]).contiguous())


def _stream_index(ny: int, nx: int, device) -> torch.Tensor:
    """Flat source index of every destination of the pull streaming."""
    y = torch.arange(ny, device=device)[:, None]
    x = torch.arange(nx, device=device)[None, :]
    planes = [k * ny * nx + ((y - CY[k]) % ny) * nx + (x - CX[k]) % nx for k in range(9)]
    return torch.stack(planes).reshape(-1)


class Solver:
    """The steps of one grid and its obstacles, for ``batch`` states at once."""

    def __init__(self, params: dict, obstacles: np.ndarray, batch: int,
                 dtype: torch.dtype, device) -> None:
        self.ny, self.nx = params["ny"], params["nx"]
        if obstacles.shape != (self.ny, self.nx):
            raise ValueError(f"obstacles {obstacles.shape} != grid {(self.ny, self.nx)}")
        self.device, self.dtype, self.batch = torch.device(device), dtype, batch
        self.omega = params["omega"]
        w1 = params["density"] * params["accel"] / 9.0
        w2 = params["density"] * params["accel"] / 36.0
        self.w1, self.w2 = w1, w2
        kick = (0.0, w1, 0.0, -w1, 0.0, w2, -w2, -w2, w2)
        self.kick = torch.tensor(kick, dtype=dtype, device=self.device)[None, :, None]
        self.cx = torch.tensor(CX, dtype=dtype, device=self.device)[None, :, None, None]
        self.cy = torch.tensor(CY, dtype=dtype, device=self.device)[None, :, None, None]
        self.w = torch.tensor(WEIGHTS, dtype=dtype, device=self.device)[None, :, None, None]
        self.opposite = torch.tensor(OPPOSITE, device=self.device)
        fluid = ~torch.as_tensor(np.asarray(obstacles, dtype=bool), device=self.device)
        self.fluid = fluid
        self.fluid_row = fluid[self.ny - 2]
        self.free_cells = int(fluid.sum())
        self.index = _stream_index(self.ny, self.nx, self.device)

    def step(self, f: torch.Tensor, av: torch.Tensor) -> None:
        """One step of ``f`` in place; the step's mean |u| into ``av[B]``."""
        row = f[:, :, self.ny - 2, :]
        ok = (self.fluid_row & (row[:, 3] - self.w1 > 0)
              & (row[:, 6] - self.w2 > 0) & (row[:, 7] - self.w2 > 0))
        row += ok[:, None, :].to(self.dtype) * self.kick
        t = f.reshape(self.batch, -1)[:, self.index].reshape(f.shape)
        rho = t.sum(1)
        ux = (t * self.cx).sum(1) / rho
        uy = (t * self.cy).sum(1) / rho
        usq = ux * ux + uy * uy
        cu = self.cx * ux[:, None] + self.cy * uy[:, None]
        feq = self.w * rho[:, None] * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq[:, None])
        relaxed = t + self.omega * (feq - t)
        f.copy_(torch.where(self.fluid, relaxed, t[:, self.opposite]))
        speed = torch.where(self.fluid, torch.sqrt(usq), torch.zeros_like(usq))
        av.copy_(speed.sum((-2, -1), dtype=torch.float64) / self.free_cells)

    def run(self, f0: torch.Tensor, steps: int) -> tuple[torch.Tensor, np.ndarray]:
        """``steps`` steps from ``f0`` (``[B, 9, ny, nx]``): the final state as
        float32 and the av series, ``[B, steps]`` float64 on the host."""
        f = f0.to(device=self.device, dtype=self.dtype).contiguous().clone()
        av = torch.empty(self.batch, steps, dtype=torch.float64, device=self.device)
        if self.device.type != "cuda":
            for s in range(steps):
                self.step(f, av[:, s])
            return f.float(), av.cpu().numpy()
        chunk = max(c for c in range(1, min(GRAPH_STEPS, steps) + 1) if steps % c == 0)
        start = f.clone()
        scratch = torch.empty(self.batch, chunk, dtype=torch.float64, device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):  # warm-up before capture, as torch asks
            for s in range(3):
                self.step(f, scratch[:, s % chunk])
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for s in range(chunk):
                self.step(f, scratch[:, s])
        f.copy_(start)
        for r in range(steps // chunk):
            graph.replay()
            av[:, r * chunk:(r + 1) * chunk].copy_(scratch)
        torch.cuda.synchronize(self.device)
        return f.float(), av.cpu().numpy()


def fields(f: torch.Tensor, obstacles: np.ndarray, density: float) -> np.ndarray:
    """``[u_x, u_y, |u|, pressure]`` of one final state ``f[9, ny, nx]``,
    in float64 on the host: u = 0 and pressure = density/3 on obstacle
    cells, pressure = rho/3 elsewhere (``final_state.dat``'s columns)."""
    f = f.detach().to("cpu", torch.float64).numpy()
    rho = f.sum(0)
    ux = np.tensordot(np.array(CX, dtype=np.float64), f, 1) / rho
    uy = np.tensordot(np.array(CY, dtype=np.float64), f, 1) / rho
    blocked = np.asarray(obstacles, dtype=bool)
    ux, uy = np.where(blocked, 0.0, ux), np.where(blocked, 0.0, uy)
    pressure = np.where(blocked, density / 3.0, rho / 3.0)
    return np.stack([ux, uy, np.sqrt(ux * ux + uy * uy), pressure])
