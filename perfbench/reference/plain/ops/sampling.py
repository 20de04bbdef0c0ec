# Frozen copy of gsavatar_torch/ops/sampling.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Area-weighted mesh surface sampling (host numpy).

The port's own copy of `gsavatar/ops/sampling.py`: `sample_surface`, which
seeds the Gaussian arena from the canonical body surface, and
`sample_skinning_pool`, the skinning loss's pool of surface points and
their SMPL weights."""
from __future__ import annotations

import numpy as np


def sample_surface(vertices: np.ndarray, faces: np.ndarray, n: int,
                   seed: int = 0):
    """Returns (points (n, 3), face_idx (n,), bary (n, 3))."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    cross = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    if total <= 0:
        probs = np.full(len(faces), 1.0 / len(faces))
    else:
        probs = area / total
    face_idx = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    b0 = 1.0 - r1
    b1 = r1 * (1.0 - r2)
    b2 = r1 * r2
    bary = np.stack([b0, b1, b2], axis=1)
    pts = (v0[face_idx] * b0[:, None] + v1[face_idx] * b1[:, None]
           + v2[face_idx] * b2[:, None])
    return pts.astype(np.float32), face_idx, bary.astype(np.float32)


def sample_skinning_pool(vertices: np.ndarray, faces: np.ndarray,
                         skinning_weights: np.ndarray, pool_size: int = 65536,
                         seed: int = 0):
    """Pool of (points (P, 3), SMPL skinning weights (P, 24)) on the body
    surface, the weights interpolated barycentrically: the training step
    draws the skinning loss's minibatch from it."""
    pts, face_idx, bary = sample_surface(vertices, faces, pool_size, seed)
    w = (skinning_weights[faces[face_idx]] * bary[..., None]).sum(axis=1)
    return pts, w.astype(np.float32)
