# Frozen copy of gsavatar_torch/camera/graphics.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Camera projection math (numpy, host-side).

The port's own copy of `gsavatar/camera/graphics.py`, which is numpy only.
Conventions follow utils/graphics_utils.py:31-77 of the original 3DGS-Avatar
code, which stores the world->view
and projection matrices TRANSPOSED (scene/cameras.py:35-40) so that points
multiply on the left as row vectors: p_view_h = p_h @ W2V_T. We keep the same
row-vector convention throughout (the rasterizer consumes these directly)."""
from __future__ import annotations

import math

import numpy as np


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.array([0.0, 0.0, 0.0]), scale=1.0) -> np.ndarray:
    """4x4 world->camera matrix (column-vector convention, NOT transposed).

    R is the camera rotation as stored by the loaders (R is transposed before
    being passed in, matching getWorld2View2: Rt[:3,:3] = R.T)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.float32(np.linalg.inv(C2W))


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-ish perspective matrix (column-vector convention), z in [0, zfar
    scale] as in the Inria pipeline."""
    tan_half_y = math.tan(fovy / 2)
    tan_half_x = math.tan(fovx / 2)
    top = tan_half_y * znear
    right = tan_half_x * znear
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov_to_focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal_to_fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))
