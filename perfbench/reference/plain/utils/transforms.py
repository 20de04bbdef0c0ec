# Frozen copy of gsavatar_torch/utils/transforms.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Rotation, quaternion and covariance math on tensors.

Counterpart of `gsavatar/utils/transforms.py`. Every function batches over
the leading axes. The per-point 3x3 products stay elementwise (`matvec3`,
`matmul3`) as in the JAX package, so both sum in the same order. Also the
training-time view-noise rotation (`augm_rot_matrix`, from explicit
angles) and the position learning-rate schedule (`expon_lr_schedule`)."""
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


def rotmat_to_quat(R, eps: float = 1e-8):
    """(..., 3, 3) -> (..., 4) wxyz: Shepperd's four candidates, each
    divided by its square root clamped at the dtype's `tiny`, the branch
    picked by `torch.where` (trace > 0, else the largest diagonal)."""
    m = R.reshape(R.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.unbind(-1)
    trace = m00 + m11 + m22
    tiny = torch.finfo(R.dtype).tiny

    def safe_div(a, b):
        return a / torch.clamp(b, min=tiny)

    def root(x):
        return torch.sqrt(torch.clamp(x + eps, min=0.0)) * 2.0

    sq_t = root(trace + 1.0)
    cand_t = torch.stack([0.25 * sq_t, safe_div(m21 - m12, sq_t),
                          safe_div(m02 - m20, sq_t),
                          safe_div(m10 - m01, sq_t)], -1)
    sq_x = root(1.0 + m00 - m11 - m22)
    cand_x = torch.stack([safe_div(m21 - m12, sq_x), 0.25 * sq_x,
                          safe_div(m01 + m10, sq_x),
                          safe_div(m02 + m20, sq_x)], -1)
    sq_y = root(1.0 + m11 - m00 - m22)
    cand_y = torch.stack([safe_div(m02 - m20, sq_y),
                          safe_div(m01 + m10, sq_y), 0.25 * sq_y,
                          safe_div(m12 + m21, sq_y)], -1)
    sq_z = root(1.0 + m22 - m00 - m11)
    cand_z = torch.stack([safe_div(m10 - m01, sq_z),
                          safe_div(m02 + m20, sq_z),
                          safe_div(m12 + m21, sq_z), 0.25 * sq_z], -1)
    where_2 = torch.where((m11 > m22)[..., None], cand_y, cand_z)
    where_1 = torch.where(((m00 > m11) & (m00 > m22))[..., None], cand_x,
                          where_2)
    return torch.where((trace > 0.0)[..., None], cand_t, where_1)


def build_scaling_rotation(s, r):
    """L = R @ diag(s). `r` is (N, 4) quaternions or (N, 3, 3) matrices."""
    R = quat_to_rotmat(r) if (r.ndim == 2 and r.shape[-1] == 4) else r
    return R * s[..., None, :]


def strip_symmetric(S):
    """(N, 3, 3) symmetric -> (N, 6) [xx, xy, xz, yy, yz, zz]."""
    return torch.stack([S[..., 0, 0], S[..., 0, 1], S[..., 0, 2],
                        S[..., 1, 1], S[..., 1, 2], S[..., 2, 2]], dim=-1)


def unstrip_symmetric(u):
    """(N, 6) [xx, xy, xz, yy, yz, zz] -> (N, 3, 3) symmetric."""
    xx, xy, xz, yy, yz, zz = u.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], dim=-2)


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


def augm_rot_matrix(rx, ry, rz):
    """The view-noise rotation rot_x @ (rot_y @ rot_z) (3, 3) from three
    angles in degrees (0-d tensors): the matrix of
    `gsavatar/utils/transforms.py:augm_rot_matrix`, whose random angles the
    caller draws (`draw_view_angles`) or is handed."""
    d = np.pi / 180.0
    sx, cx = torch.sin(d * rx), torch.cos(d * rx)
    sy, cy = torch.sin(d * ry), torch.cos(d * ry)
    sz, cz = torch.sin(d * rz), torch.cos(d * rz)
    one, zero = torch.ones_like(sx), torch.zeros_like(sx)

    def mat(*rows):
        return torch.stack([torch.stack(r) for r in rows])

    rot_x = mat((one, zero, zero), (zero, cx, -sx), (zero, sx, cx))
    rot_y = mat((cy, zero, sy), (zero, one, zero), (-sy, zero, cy))
    rot_z = mat((cz, -sz, zero), (sz, cz, zero), (zero, zero, one))
    return rot_x @ (rot_y @ rot_z)


def draw_view_angles(generator: torch.Generator, roll: float, pitch: float,
                     yaw: float):
    """The random angles of `augm_rot_matrix` (degrees, f32): a normal draw
    times the roll range, a uniform draw times the pitch range and a normal
    draw times the yaw range, each clipped to twice its range, as the JAX
    package draws them."""
    n = torch.randn(2, generator=generator)
    u = torch.rand(1, generator=generator)
    rx = torch.clamp(n[0] * roll, -2 * roll, 2 * roll)
    ry = torch.clamp(u[0] * pitch, -2 * pitch, 2 * pitch)
    rz = torch.clamp(n[1] * yaw, -2 * yaw, 2 * yaw)
    return torch.stack([rx, ry, rz])


def expon_lr_schedule(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1000000):
    """Log-linear learning-rate interpolation with an optional sine delay
    ramp, in f32 as the JAX package computes it. Returns a function
    step -> lr (a Python float)."""
    def helper(step):
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        step = torch.tensor(float(step), dtype=torch.float32)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * np.pi * torch.clamp(step / lr_delay_steps, 0, 1))
        else:
            delay_rate = 1.0
        t = torch.clamp(step / max_steps, 0, 1)
        log_lerp = torch.exp(float(np.log(lr_init)) * (1 - t)
                             + float(np.log(lr_final)) * t)
        lr = delay_rate * log_lerp
        return 0.0 if float(step) < 0 else float(lr)
    return helper
