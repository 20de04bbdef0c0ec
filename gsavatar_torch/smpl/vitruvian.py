"""Vitruvian ("star") canonicalization transforms.

Counterpart of `gsavatar/smpl/vitruvian.py`: the numpy version used at
dataset set-up and the tensor version used inside pose correction. Both
rotate the two leg chains by +-45 degrees about z."""
from __future__ import annotations

import numpy as np
import torch

from gsavatar_torch.utils.transforms import euler_z

_CHAIN_L = range(1, 13, 3)   # L-hip, L-knee, L-ankle, L-foot: 1, 4, 7, 10
_CHAIN_R = range(2, 14, 3)   # R-hip, R-knee, R-ankle, R-foot: 2, 5, 8, 11


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


def _euler_z_on(deg: float, device) -> torch.Tensor:
    """`euler_z(deg)` as a float32 (3, 3) tensor on `device`, written there
    from Python numbers: no host-to-device copy, which would wait for the
    GPU and which a CUDA graph cannot capture."""
    R = torch.zeros(3, 3, dtype=torch.float32, device=device)
    for (i, j), v in np.ndenumerate(euler_z(deg).astype(np.float32)):
        if v:
            R[i, j].fill_(float(v))
    return R


def get_02v_bone_transforms_torch(Jtr):
    """The same on a (24, 3) tensor, differentiable in the joints; every
    constant is made on the tensor's device (`_euler_z_on`, each chain's
    joints by `arange`)."""
    out = torch.eye(4, dtype=Jtr.dtype, device=Jtr.device).repeat(24, 1, 1)
    for chain, deg in ((_CHAIN_L, 45), (_CHAIN_R, -45)):
        R = _euler_z_on(deg, Jtr.device)
        ts = []
        for i, j_idx in enumerate(chain):
            t = Jtr[j_idx]
            if i > 0:
                t = R @ (t - Jtr[chain[i - 1]]) + ts[i - 1]
            ts.append(t)
        ts = torch.stack(ts) - torch.stack([Jtr[j] for j in chain]) @ R.T
        idx = torch.arange(chain.start, chain.stop, chain.step,
                           device=Jtr.device)
        out[idx, :3, :3] = R
        out[idx, :3, 3] = ts
    return out
