"""Camera: world coordinates -> supersampled accumulator addresses.

Port of `cuburn_tpu/ops/camera.py`.  `CameraSpec` is plain Python but
its JAX module imports jax at the top, so it is copied here unchanged.
Conventions: image row 0 is the top and world +y maps downward;
`rotate` (degrees) rotates the image counterclockwise; the accumulator
is (H*ss + 2*gutter) x (W*ss + 2*gutter) with address
py * acc_width + px, and out-of-bounds points go to a junk bin at index
n_bins.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_DEG2RAD = float(np.float32(np.pi / 180.0))
_TWO_PI = float(np.float32(2.0 * np.pi))
_TENTH = float(np.float32(0.1))


@dataclass(frozen=True)
class CameraSpec:
    """Static camera geometry.

    `no_rotation=True` skips the rotation math (the genome's rotate
    spline is constantly zero).  `gutter` is the border margin in
    accumulator pixels that keeps the density-estimation blur and the
    spatial filter from clipping at the frame edge.  `tile_row0`,
    `full_acc_height` and `tile_acc_height` make the camera a
    horizontal stripe of a taller frame, projected in full-frame
    coordinates."""
    width: int          # output width, pixels
    height: int         # output height, pixels
    ss: int = 1         # supersampling factor
    no_rotation: bool = False
    gutter: int = 0
    tile_row0: int = 0          # stripe's first row in full acc pixels
    full_acc_height: int = 0    # 0 = untiled
    tile_acc_height: int = 0    # stripe's own acc rows (0 = untiled)

    @property
    def acc_width(self) -> int:
        return self.width * self.ss + 2 * self.gutter

    @property
    def acc_height(self) -> int:
        if self.tile_acc_height:
            return self.tile_acc_height
        return self.height * self.ss + 2 * self.gutter

    @property
    def n_bins(self) -> int:
        return self.acc_width * self.acc_height

    @property
    def layout_bins(self) -> int:
        """Bin count that fixes the packed-record bit split: the full
        frame's, even for a stripe camera."""
        if self.full_acc_height:
            return self.acc_width * self.full_acc_height
        return self.n_bins

    @property
    def junk_bin(self) -> int:
        return self.n_bins


def project_3d(cam3d, x, y, u1=None, u2=None):
    """Apophysis-7X 3-D camera: yaw/pitch rotation of the z=0 plane,
    perspective divide and depth-of-field blur (the algorithm is
    documented at the JAX counterpart).  `cam3d` is the (5,) tensor
    [yaw, pitch, perspective, zpos, dof]; `u1`/`u2` are per-point
    uniforms for the DOF blur, None when the genome has no DOF."""
    yaw, pitch, persp, zpos, dof = (cam3d[i] for i in range(5))
    z = -zpos
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    x1 = x * cy + y * sy
    y1 = y * cy - x * sy
    y2 = y1 * cp - z * sp
    depth = y1 * sp + z * cp
    zr = 1.0 - persp * depth
    if u1 is not None:
        dr = u1 * (_TENTH * dof * z)
        t = u2 * _TWO_PI
        x1 = x1 + dr * torch.cos(t)
        y2 = y2 + dr * torch.sin(t)
    return x1 / zr, y2 / zr


def project(spec: CameraSpec, center, ppu, rotate_deg, x, y,
            rot_center=None):
    """World point tensors -> (addr (int64), in_bounds (bool)).

    `ppu` is pixels per world unit at the render width (the caller
    scales the genome's value).  `rot_center` is the rotation pivot
    (None = `center`).  Bounds are tested on the float coordinates so
    NaN and inf points fail them before the integer cast."""
    if spec.no_rotation:
        rx = x - center[0]
        ry = y - center[1]
    else:
        rc = center if rot_center is None else rot_center
        dx = x - rc[0]
        dy = y - rc[1]
        theta = -rotate_deg * _DEG2RAD
        ct, st = torch.cos(theta), torch.sin(theta)
        rx = ct * dx - st * dy + (rc[0] - center[0])
        ry = st * dx + ct * dy + (rc[1] - center[1])
    ppu_ss = ppu * float(spec.ss)
    full_h = spec.full_acc_height or spec.acc_height
    px = rx * ppu_ss + float(np.float32(spec.acc_width * 0.5))
    py = ry * ppu_ss + float(np.float32(full_h * 0.5))
    row0 = spec.tile_row0
    in_bounds = ((px >= 0) & (px < spec.acc_width) &
                 (py >= float(row0)) &
                 (py < float(row0 + spec.acc_height)))
    ix = torch.floor(px).to(torch.int64)
    iy = torch.floor(py).to(torch.int64) - row0
    addr = torch.where(in_bounds, iy * spec.acc_width + ix,
                       spec.junk_bin)
    return addr, in_bounds
