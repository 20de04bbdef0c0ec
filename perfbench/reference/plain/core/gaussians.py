# Frozen copy of gsavatar_torch/core/gaussians.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Fixed-capacity Gaussian arena.

Counterpart of `gsavatar/core/gaussians.py`: `capacity` preallocated slots
plus an `alive` mask, so that the port's arena is slot-for-slot the JAX
package's. A `Gaussians` view is what the converter deforms and the
renderer draws; deformers replace fields with `replace`.

Colour modes: `use_sh` -> features_dc (N, 1, 3) + features_rest
(N, (deg+1)^2 - 1, 3); feature mode -> features_dc (N, 1, 1) + features_rest
(N, feature_dim - 1, 1)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from perfbench.reference.plain.ops import knn, sh
from perfbench.reference.plain.utils import transforms as T


@dataclasses.dataclass
class GaussianParams:
    """Learnable arena tensors (before activation)."""
    xyz: torch.Tensor            # (N, 3)
    features_dc: torch.Tensor    # (N, 1, C)
    features_rest: torch.Tensor  # (N, R, C)
    scaling: torch.Tensor        # (N, 3) log-scale
    rotation: torch.Tensor       # (N, 4) unnormalized quaternion wxyz
    opacity: torch.Tensor        # (N, 1) logit

    def replace(self, **kw) -> "GaussianParams":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "GaussianParams":
        return GaussianParams(**{f.name: fn(getattr(self, f.name))
                                 for f in dataclasses.fields(self)})


K_NEIGHBORS = 5  # AIAP neighbour count


@dataclasses.dataclass
class GaussianAux:
    """Arena state that is not learned: the alive mask, the densification
    statistics and the cached AIAP neighbours (recomputed on the densify
    cadence, not every step)."""
    alive: torch.Tensor               # (N,) bool
    max_radii2d: torch.Tensor         # (N,) f32
    xyz_gradient_accum: torch.Tensor  # (N,) f32
    denom: torch.Tensor               # (N,) f32
    nn_ix: torch.Tensor               # (N, K_NEIGHBORS) int32

    def replace(self, **kw) -> "GaussianAux":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "GaussianAux":
        return GaussianAux(**{f.name: fn(getattr(self, f.name))
                              for f in dataclasses.fields(self)})


@dataclasses.dataclass
class Gaussians:
    """A (possibly deformed) view of the arena, as fed to the renderer."""
    params: GaussianParams
    alive: torch.Tensor
    rotation_precomp: Optional[torch.Tensor] = None   # (N, 3, 3)
    fwd_transform: Optional[torch.Tensor] = None      # (N, 4, 4), detached
    non_rigid_feature: Optional[torch.Tensor] = None  # (N, F)
    active_sh_degree: int = 0
    max_sh_degree: int = 3
    use_sh: bool = True

    def replace(self, **kw) -> "Gaussians":
        return dataclasses.replace(self, **kw)

    @property
    def get_xyz(self):
        return self.params.xyz

    @property
    def get_scaling(self):
        return torch.exp(self.params.scaling)

    @property
    def get_rotation(self):
        return T.quat_normalize(self.params.rotation)

    @property
    def get_opacity(self):
        return torch.sigmoid(self.params.opacity)

    @property
    def get_features(self):
        return torch.cat([self.params.features_dc,
                          self.params.features_rest], dim=1)

    def get_covariance(self, scaling_modifier=1.0):
        rot = (self.rotation_precomp if self.rotation_precomp is not None
               else self.params.rotation)
        return T.covariance_from_scaling_rotation(
            self.get_scaling, scaling_modifier, rot)


def empty_params(capacity: int, use_sh: bool, sh_degree: int = 3,
                 feature_dim: int = 32, device='cpu') -> GaussianParams:
    if use_sh:
        rest, ch = (sh_degree + 1) ** 2 - 1, 3
    else:
        rest, ch = feature_dim - 1, 1
    z = lambda *shape: torch.zeros(shape, device=device)
    rotation = z(capacity, 4)
    rotation[:, 0] = 1.0
    return GaussianParams(
        xyz=z(capacity, 3), features_dc=z(capacity, 1, ch),
        features_rest=z(capacity, rest, ch), scaling=z(capacity, 3),
        rotation=rotation, opacity=z(capacity, 1))


def empty_aux(capacity: int, device='cpu') -> GaussianAux:
    z = torch.zeros(capacity, device=device)
    return GaussianAux(
        alive=torch.zeros(capacity, dtype=torch.bool, device=device),
        max_radii2d=z, xyz_gradient_accum=z.clone(), denom=z.clone(),
        nn_ix=torch.zeros((capacity, K_NEIGHBORS), dtype=torch.int32,
                          device=device))


def create_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                    use_sh: bool, sh_degree: int = 3, feature_dim: int = 32,
                    device='cpu'):
    """Seed the arena from a point cloud: RGB -> SH DC (SH mode only),
    log(sqrt(mean 3-NN squared distance)) scales, identity rotations,
    opacity logit of 0.1, and each point's K_NEIGHBORS nearest neighbours
    for the AIAP losses."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points do not fit an arena of {capacity}")
    params = empty_params(capacity, use_sh, sh_degree, feature_dim, device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    dist2 = knn.mean_dist3(pts).clamp_min(1e-7)
    params.xyz[:n] = pts
    params.scaling[:n] = torch.log(torch.sqrt(dist2))[:, None]
    params.opacity[:n] = T.inverse_sigmoid(
        0.1 * torch.ones((n, 1), device=device))
    if use_sh:
        params.features_dc[:n, 0] = sh.rgb_to_sh(torch.as_tensor(
            np.asarray(colors, np.float32), device=device))
    aux = empty_aux(capacity, device)
    aux.alive[:n] = True
    aux.nn_ix[:n] = knn.knn_self(pts, K_NEIGHBORS)
    return params, aux


def make_view(params: GaussianParams, aux: GaussianAux, *, active_sh_degree=0,
              max_sh_degree=3, use_sh=True, bucket: int = 0) -> Gaussians:
    """`bucket` > 0 keeps only the first `bucket` slots (the alive prefix),
    so that every stage runs over about n_alive rows, not capacity."""
    alive = aux.alive
    if bucket:
        params = params.map(lambda x: x[:bucket])
        alive = alive[:bucket]
    return Gaussians(params=params, alive=alive,
                     active_sh_degree=active_sh_degree,
                     max_sh_degree=max_sh_degree, use_sh=use_sh)
