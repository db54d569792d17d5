# Frozen copy of qrw_tpu_torch/sim/terrain.py as of the benchmark's first version;
# a plain reference: it imports nothing of the port.
"""Terrain height fields: flat, procedural bumpy and the stairs course.

Port of qrw_tpu/sim/terrain.py. The ground is a height function h(x, y)
sampled by the contact model, so a fleet's robots can each stand on
their own terrain:

  * `make_bumpy` is the reference's procedural heightfield: python
    `random.Random(41)`, uniform heights up to 0.05 m on a 512 x 512
    grid at 0.05 m, with the duplicated 2 x 2 cell pattern and the
    (height + prev) / 2 smoothing.
  * `make_stairs` is the envID = 1 obstacle course: the Bauzil
    staircase (a rasterized heightfield, `bauzil_stairs_hf.npz`, this
    package's own copy) plus the red (1.0 x 0.1 x 0.02 m) and green
    (0.2 x 0.1 x 0.01 m) perturbation steps.

Heights are bilinearly interpolated (row <- y, col <- x); the contact
normal stays vertical.
"""

from __future__ import annotations

import os
import random
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

# the staircase heightfield shipped with the package (make_stairs)
STAIRS_HF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "bauzil_stairs_hf.npz")


class Terrain(NamedTuple):
    heights: torch.Tensor   # (H, W) height samples [m]
    cell: torch.Tensor      # () grid spacing [m]
    origin: torch.Tensor    # (2,) world xy of heights[0, 0]


class FleetTerrain(NamedTuple):
    """Per-robot terrain of a heterogeneous fleet: robot b stands on
    `terrains[tid[b] - 1]` (tid 0: the flat plane)."""
    tid: torch.Tensor       # (B,) int32: 0 flat, i >= 1 -> terrains[i-1]
    terrains: tuple         # tuple of Terrain


def height_at(terrain, xy):
    """Bilinear ground height at world xy (..., 2); 0 when terrain is
    None. For a FleetTerrain the last batch axis of xy is the robot axis
    (e.g. (4, B, 2)) and broadcasts against tid (B,)."""
    if terrain is None:
        return torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
    if isinstance(terrain, FleetTerrain):
        h = torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
        for i, t in enumerate(terrain.terrains):
            h = torch.where(terrain.tid == i + 1, height_at(t, xy), h)
        return h
    if not isinstance(terrain, Terrain):
        raise TypeError(f"not a terrain: {type(terrain).__name__}")
    hmap = terrain.heights
    H, W = hmap.shape
    g = (xy - terrain.origin) / terrain.cell
    gi = torch.clamp(g[..., 1], 0.0, H - 1.001)   # row <- y
    gj = torch.clamp(g[..., 0], 0.0, W - 1.001)   # col <- x
    i0 = torch.floor(gi).to(torch.int64)
    j0 = torch.floor(gj).to(torch.int64)
    fi = gi - i0
    fj = gj - j0
    h00 = hmap[i0, j0]
    h01 = hmap[i0, j0 + 1]
    h10 = hmap[i0 + 1, j0]
    h11 = hmap[i0 + 1, j0 + 1]
    return ((1 - fi) * ((1 - fj) * h00 + fj * h01)
            + fi * ((1 - fj) * h10 + fj * h11))


def _grid(data, cell, half, dtype, device) -> Terrain:
    kw = dict(dtype=dtype, device=device)
    return Terrain(heights=torch.as_tensor(data).to(**kw),
                   cell=torch.tensor(cell, **kw),
                   origin=torch.tensor([-half, -half], **kw))


@lru_cache(maxsize=2)
def _bumpy_np(rows: int, amplitude: float) -> np.ndarray:
    rnd = random.Random(41)                      # the reference's seed
    data = np.zeros((rows, rows))
    height_prev = 0.0
    for j in range(rows // 2):
        for i in range(rows // 2):
            height = rnd.uniform(0, amplitude)
            data[2 * j, 2 * i] = (height + height_prev) * 0.5
            data[2 * j, 2 * i + 1] = height
            data[2 * j + 1, 2 * i] = (height + height_prev) * 0.5
            data[2 * j + 1, 2 * i + 1] = height
            height_prev = height
    return data


def make_bumpy(rows: int = 512, cell: float = 0.05,
               amplitude: float = 0.05, dtype=torch.float32,
               device="cuda") -> Terrain:
    """The use_flat_plane=False procedural terrain, centered on the
    origin, heights shifted so the ground under the start is ~0."""
    data = _bumpy_np(rows, amplitude).copy()
    c = rows // 2
    data -= data[c - 2:c + 3, c - 2:c + 3].mean()
    return _grid(data, cell, rows * cell / 2.0, dtype, device)


def _add_box(data, cell, half, cx, cy, sx, sy, h):
    """Raise a rectangular patch (world center cx, cy; full sizes sx, sy)."""
    rows = data.shape[0]
    i0 = max(0, int((cy - sy / 2 + half) / cell))
    i1 = min(rows, int((cy + sy / 2 + half) / cell) + 1)
    j0 = max(0, int((cx - sx / 2 + half) / cell))
    j1 = min(rows, int((cx + sx / 2 + half) / cell) + 1)
    data[i0:i1, j0:j1] = np.maximum(data[i0:i1, j0:j1], h)


def _bauzil_heights():
    """The Bauzil staircase (the reference's bauzil_stairs.stl under its
    URDF transform) rasterized into a 2 cm max-z heightfield: returns
    (heights (H, W) f32, cell, origin (2,))."""
    with np.load(STAIRS_HF) as f:
        return (np.asarray(f["heights"], np.float32), float(f["cell"]),
                np.asarray(f["origin"], np.float32))


def make_stairs(rows: int = 512, cell: float = 0.02, dtype=torch.float32,
                device="cuda") -> Terrain:
    """The envID=1 obstacle course: the Bauzil staircase resampled onto
    this grid by nearest cell, plus the red and green steps."""
    half = rows * cell / 2.0
    bh, bcell, borig = _bauzil_heights()
    H, W = bh.shape
    ys = (np.arange(rows) * cell - half - borig[1]) / bcell   # grid rows
    xs = (np.arange(rows) * cell - half - borig[0]) / bcell
    iy = np.clip(np.round(ys).astype(int), 0, H - 1)
    ix = np.clip(np.round(xs).astype(int), 0, W - 1)
    inside = ((ys >= 0) & (ys <= H - 1))[:, None] \
        & ((xs >= 0) & (xs <= W - 1))[None, :]
    data = np.where(inside, bh[iy][:, ix], 0.0)
    # red steps: 1.0 x 0.1 x 0.02 m at y = 0.5 + 0.2 i
    for i in range(4):
        _add_box(data, cell, half, 0.0, 0.5 + 0.2 * i, 1.0, 0.1, 0.02)
    _add_box(data, cell, half, 0.5, 0.5 + 0.2 * 4, 1.0, 0.1, 0.02)
    _add_box(data, cell, half, 0.5, 0.5 + 0.2 * 5, 1.0, 0.1, 0.02)
    # green steps: 0.2 x 0.1 x 0.01 m at x = +-0.15, y = 0.9 + 0.2 i
    for i in range(3):
        _add_box(data, cell, half, 0.15 * (-1) ** i, 0.9 + 0.2 * i,
                 0.2, 0.1, 0.01)
    return _grid(data, cell, half, dtype, device)


def make_terrain(cfg, dtype=torch.float32, device="cuda"
                 ) -> Optional[Terrain]:
    """Terrain from the config flags (use_flat_plane, envID); None for
    the flat plane."""
    if cfg.envID == 1:
        return make_stairs(dtype=dtype, device=device)
    if not cfg.use_flat_plane:
        return make_bumpy(dtype=dtype, device=device)
    return None
