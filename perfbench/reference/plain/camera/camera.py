# Frozen copy of gsavatar_torch/camera/camera.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Camera record: one frame's render inputs as tensors.

Counterpart of `gsavatar/camera/camera.py`. A plain dataclass: the matrices
and the avatar pose are tensors, the per-frame latent/pose indices and the
"frame is in frame_dict" flag are Python numbers (they pick rows and gate
blends; keeping them on the host costs no device sync). `image` (H, W, 3)
and `mask` (H, W) are the ground truth of a training camera; cameras of
the serving path carry none."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import graphics


@dataclasses.dataclass
class Camera:
    world_view_transform: torch.Tensor  # (4, 4) = W2V^T (row-vector)
    full_proj_transform: torch.Tensor   # (4, 4) = W2V^T @ P^T
    camera_center: torch.Tensor         # (3,)
    rots: torch.Tensor                  # (1, 24, 9) rotation matrices
    Jtrs: torch.Tensor                  # (1, 24, 3) normalized joints
    bone_transforms: torch.Tensor       # (24, 4, 4) canonical -> posed
    image: Optional[torch.Tensor] = None  # (H, W, 3) in [0, 1]
    mask: Optional[torch.Tensor] = None   # (H, W) {0, 1}
    latent_idx: int = 0
    pose_idx: int = 0
    in_frame_dict: float = 1.0
    fovx: float = 0.0
    fovy: float = 0.0
    width: int = 0
    height: int = 0
    znear: float = 0.01
    zfar: float = 100.0
    frame_id: int = 0
    cam_id: int = 0
    image_name: str = ""
    K: Optional[np.ndarray] = None      # (3, 3) intrinsics of a live camera

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Camera":
        return self.replace(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def make_camera(*, R, T, fovx, fovy, width, height, rots, Jtrs,
                bone_transforms, frame_id=0, cam_id=0, image_name="",
                latent_idx=0, pose_idx=0, in_frame_dict=1.0, znear=0.01,
                zfar=100.0, trans=np.array([0.0, 0.0, 0.0]), scale=1.0,
                device='cpu') -> Camera:
    """Derived transforms computed on the host exactly as the JAX package
    does (transposed storage, row-vector products), then put on `device`."""
    w2v = graphics.world_to_view(R, T, trans, scale).T
    proj = graphics.projection_matrix(znear, zfar, fovx, fovy).T
    full = (w2v @ proj).astype(np.float32)
    cam_center = np.linalg.inv(w2v)[3, :3].astype(np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        world_view_transform=t(w2v), full_proj_transform=t(full),
        camera_center=t(cam_center), rots=t(rots), Jtrs=t(Jtrs),
        bone_transforms=t(bone_transforms), latent_idx=int(latent_idx),
        pose_idx=int(pose_idx), in_frame_dict=float(in_frame_dict),
        fovx=float(fovx), fovy=float(fovy), width=int(width),
        height=int(height), znear=float(znear), zfar=float(zfar),
        frame_id=int(frame_id), cam_id=int(cam_id), image_name=image_name)
