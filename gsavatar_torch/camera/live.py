"""Live camera: one frame's render inputs from a raw (R, T, K).

Counterpart of `gsavatar/camera/live.py` (scene/duck_camera.py of the
original code). The world-to-view matrix is stored transposed with the
translation in its last row (`W2V^T` rows `[R | 0]`, then `[T | 1]`), the
full projection is `W2V^T @ P^T` and the camera centre the last row of
its inverse, all computed on the host in float32 as the JAX package does,
then put on the device. Without K the focal length is CLIFF's
`sqrt(h^2 + w^2)`. The pose fields default to zeros and identities; the
camera is outside every training frame (`latent_idx = pose_idx = 0`,
`in_frame_dict = 0`), so the pose correction's tables are read but not
blended in."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from gsavatar_torch import tracing
from gsavatar_torch.camera import graphics
from gsavatar_torch.camera.camera import Camera
from gsavatar_torch.device import resolve_device


def estimate_focal_length(h: int, w: int) -> float:
    """CLIFF's focal heuristic (common/utils.py of the original code)."""
    return math.sqrt(h * h + w * w)


def default_K(width: int, height: int) -> np.ndarray:
    f = estimate_focal_length(height, width)
    return np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                    np.float32)


def live_camera(R, T, *, K: Optional[np.ndarray] = None, width: int = 1280,
                height: int = 720, znear: float = 0.01, zfar: float = 100.0,
                rots=None, Jtrs=None, bone_transforms=None,
                frame_id: int = 0, device=None) -> Camera:
    """A camera for `render_frame` from the rotation R (3, 3) and the
    translation T (3,), its tensors on `device` (default the GPU)."""
    with tracing.span('camera/live'):
        dev = resolve_device(device)
        if K is None:
            K = default_K(width, height)
        fovx = graphics.focal_to_fov(K[0, 0], width)
        fovy = graphics.focal_to_fov(K[1, 1], height)

        w2v_t = np.zeros((4, 4), np.float32)
        w2v_t[:3, :3] = np.asarray(R, np.float32)
        w2v_t[3, :3] = np.asarray(T, np.float32).ravel()
        w2v_t[3, 3] = 1.0
        proj_t = graphics.projection_matrix(znear, zfar, fovx, fovy).T
        full = (w2v_t @ proj_t).astype(np.float32)
        cam_center = np.linalg.inv(w2v_t)[3, :3].astype(np.float32)

        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        eye24 = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
        return Camera(
            world_view_transform=t(w2v_t), full_proj_transform=t(full),
            camera_center=t(cam_center),
            rots=t(np.zeros((1, 24, 9), np.float32) if rots is None
                   else rots),
            Jtrs=t(np.zeros((1, 24, 3), np.float32) if Jtrs is None
                   else Jtrs),
            bone_transforms=t(eye24 if bone_transforms is None
                              else bone_transforms),
            latent_idx=0, pose_idx=0, in_frame_dict=0.0, fovx=float(fovx),
            fovy=float(fovy), width=int(width), height=int(height),
            znear=float(znear), zfar=float(zfar), frame_id=int(frame_id),
            K=np.asarray(K))
