"""Rotation, quaternion and covariance math on tensors.

Counterpart of `gsavatar/utils/transforms.py`. Every function batches over
the leading axes. The per-point 3x3 products stay elementwise (`matvec3`,
`matmul3`) as in the JAX package, so both sum in the same order."""
from __future__ import annotations

import numpy as np
import torch


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def quat_normalize(q):
    """Normalize (..., 4) wxyz quaternions."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def matvec3(R, v):
    """Batched (..., 3, 3) @ (..., 3) as multiply and sum."""
    return (R * v[..., None, :]).sum(-1)


def matmul3(A, B):
    """Batched (..., 3, 3) @ (..., 3, 3) as multiply and sum."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def quat_to_rotmat(q):
    """(..., 4) wxyz, not necessarily unit -> (..., 3, 3)."""
    q = quat_normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def quat_multiply(r, s):
    """Hamilton product of wxyz quaternions, broadcasting over batch axes."""
    r0, r1, r2, r3 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    s0, s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    return torch.stack([
        r0 * s0 - r1 * s1 - r2 * s2 - r3 * s3,
        r0 * s1 + r1 * s0 + r2 * s3 - r3 * s2,
        r0 * s2 - r1 * s3 + r2 * s0 + r3 * s1,
        r0 * s3 + r1 * s2 - r2 * s1 + r3 * s0,
    ], dim=-1)


def build_scaling_rotation(s, r):
    """L = R @ diag(s). `r` is (N, 4) quaternions or (N, 3, 3) matrices."""
    R = quat_to_rotmat(r) if (r.ndim == 2 and r.shape[-1] == 4) else r
    return R * s[..., None, :]


def strip_symmetric(S):
    """(N, 3, 3) symmetric -> (N, 6) [xx, xy, xz, yy, yz, zz]."""
    return torch.stack([S[..., 0, 0], S[..., 0, 1], S[..., 0, 2],
                        S[..., 1, 1], S[..., 1, 2], S[..., 2, 2]], dim=-1)


def covariance_from_scaling_rotation(scaling, scaling_modifier, rotation):
    """Sigma = L L^T with L = R diag(m * s), as the upper-triangle 6-vector."""
    L = build_scaling_rotation(scaling_modifier * scaling, rotation)
    S = (L[..., :, None, :] * L[..., None, :, :]).sum(-1)
    return strip_symmetric(S)


def rodrigues(aa):
    """Axis-angle (N, 3) -> rotation matrices (N, 3, 3), with the +1e-8
    inside the norm that keeps theta = 0 finite."""
    angle = torch.linalg.vector_norm(aa + 1e-8, dim=-1, keepdim=True)
    rot_dir = aa / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir[..., 0], rot_dir[..., 1], rot_dir[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=-1).reshape(aa.shape[:-1] + (3, 3))
    ident = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return ident + sin * K + (1 - cos) * (K @ K)


def euler_z(deg: float) -> np.ndarray:
    """Host-side rotation about z by `deg` degrees, (3, 3) float64."""
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float64)
