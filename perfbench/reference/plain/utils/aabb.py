# Frozen copy of gsavatar_torch/utils/aabb.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Axis-aligned bounding box (counterpart of `gsavatar/utils/aabb.py`).

A module with two buffers, so that a model holding one moves it with
`.to(device)`. The buffers are not persistent: they are subject metadata,
not trained state."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


class AABB(nn.Module):
    def __init__(self, coord_max, coord_min):
        super().__init__()
        self.register_buffer('coord_max', torch.as_tensor(
            np.asarray(coord_max, np.float32)), persistent=False)
        self.register_buffer('coord_min', torch.as_tensor(
            np.asarray(coord_min, np.float32)), persistent=False)

    @classmethod
    def from_points(cls, pts: np.ndarray, padding=0.0) -> "AABB":
        coord_max = np.max(pts, axis=0)
        coord_min = np.min(pts, axis=0)
        pad = (coord_max - coord_min) * padding
        return cls((coord_max + pad).astype(np.float32),
                   (coord_min - pad).astype(np.float32))

    def copy(self) -> "AABB":
        return AABB(self.coord_max.cpu().numpy(), self.coord_min.cpu().numpy())

    def normalize(self, x, sym: bool = False):
        x = (x - self.coord_min) / (self.coord_max - self.coord_min)
        return 2 * x - 1.0 if sym else x
