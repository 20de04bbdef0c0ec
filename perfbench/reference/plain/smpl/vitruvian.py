# Frozen copy of gsavatar_torch/smpl/vitruvian.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Vitruvian ("star") canonicalization transforms.

Counterpart of `gsavatar/smpl/vitruvian.py`: the numpy version used at
dataset set-up and the tensor version used inside pose correction. Both
rotate the two leg chains by +-45 degrees about z."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.plain.utils.transforms import euler_z

_CHAIN_L = (1, 4, 7, 10)   # L-hip, L-knee, L-ankle, L-foot
_CHAIN_R = (2, 5, 8, 11)   # R-hip, R-knee, R-ankle, R-foot


def get_02v_bone_transforms(joints: np.ndarray) -> np.ndarray:
    """joints (24, 3) -> (24, 4, 4) transforms from the rest A-pose to the
    star pose (identity everywhere except the leg chains)."""
    joints = np.asarray(joints, np.float64)
    trans = np.tile(np.eye(4), (24, 1, 1))

    for chain, R in ((_CHAIN_L, euler_z(45)), (_CHAIN_R, euler_z(-45))):
        for i, j_idx in enumerate(chain):
            trans[j_idx, :3, :3] = R
            t = joints[j_idx].copy()
            if i > 0:
                parent = chain[i - 1]
                t = R @ (t - joints[parent])
                t += trans[parent, :3, -1]
            trans[j_idx, :3, -1] = t
        trans[list(chain), :3, -1] -= joints[list(chain)] @ R.T

    return trans.astype(np.float32)


def get_02v_bone_transforms_torch(Jtr):
    """The same on a (24, 3) tensor, differentiable in the joints."""
    out = torch.eye(4, dtype=Jtr.dtype, device=Jtr.device).repeat(24, 1, 1)
    for chain, deg in ((_CHAIN_L, 45), (_CHAIN_R, -45)):
        R = torch.as_tensor(euler_z(deg), dtype=torch.float32,
                            device=Jtr.device)
        ts = []
        for i, j_idx in enumerate(chain):
            t = Jtr[j_idx]
            if i > 0:
                t = R @ (t - Jtr[chain[i - 1]]) + ts[i - 1]
            ts.append(t)
        ts = torch.stack(ts) - torch.stack([Jtr[j] for j in chain]) @ R.T
        idx = list(chain)
        out[idx, :3, :3] = R
        out[idx, :3, 3] = ts
    return out
