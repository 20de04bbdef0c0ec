# Frozen copy of gsavatar_torch/models/pose_encoder.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Hierarchical (LEAP-style) body-pose encoder.

Counterpart of `gsavatar/models/pose_encoder.py`: a global linear over all
joint rotations and positions feeds the root; each joint's 2-layer MLP
consumes [rot (9), Jtr (3), bone length (1), parent feature], walking down
the fixed SMPL tree."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from perfbench.reference.plain.smpl.body_model import KTREE_PARENTS
from .mlp import torch_dense


class HierarchicalPoseEncoder(nn.Module):
    def __init__(self, num_joints: int = 24, rel_joints: bool = False,
                 dim_per_joint: int = 6, out_dim: int = -1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_joints = num_joints
        self.rel_joints = rel_joints
        self.out_dim = out_dim
        d = dim_per_joint
        self.layer_0 = torch_dense(num_joints * 12, d, generator)
        self.layers = nn.ModuleList([
            nn.Sequential(torch_dense(13 + d, 13 + d, generator), nn.ReLU(),
                          torch_dense(13 + d, d, generator))
            for _ in range(num_joints)])
        self.n_output_dims = out_dim if out_dim > 0 else num_joints * d
        if out_dim > 0:
            self.out_layer = torch_dense(num_joints * d, out_dim, generator)

    def forward(self, rots, Jtrs):
        """rots (B, 24, 9), Jtrs (B, 24, 3) -> (B, n_output_dims)."""
        B = rots.shape[0]
        parents = KTREE_PARENTS
        if self.rel_joints:
            Jtrs = torch.cat([Jtrs[:, :1],
                              Jtrs[:, 1:] - Jtrs[:, parents[1:]]], dim=1
                             ).detach()
        global_feat = self.layer_0(torch.cat([rots.reshape(B, -1),
                                              Jtrs.reshape(B, -1)], dim=-1))
        out = [None] * self.num_joints
        for j in range(self.num_joints):
            Jtr = Jtrs[:, j]
            parent = int(parents[j])
            if parent == -1:
                bone_l = torch.linalg.vector_norm(Jtr, dim=-1, keepdim=True)
                feat = global_feat
            else:
                bone_l = torch.linalg.vector_norm(
                    Jtr if self.rel_joints else Jtr - Jtrs[:, parent],
                    dim=-1, keepdim=True)
                feat = out[parent]
            out[j] = self.layers[j](torch.cat([rots[:, j], Jtr, bone_l, feat],
                                              dim=-1))
        y = torch.cat(out, dim=-1)
        if self.out_dim > 0:
            y = self.out_layer(y)
        return y
