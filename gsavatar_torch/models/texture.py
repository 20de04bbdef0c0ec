"""Colour decoding: spherical harmonics or the latent MLP.

Counterpart of `gsavatar/models/texture.py`, selected by `cfg['name']`:
* `SH2RGB` ('sh2rgb' or 'sh'): max(SH(active degree) at the view
  direction + 0.5, 0), the plain 3DGS colour;
* `ColorMLP` ('mlp'): per-Gaussian feature ++ the optional normalised
  position, covariance and quasi-normal ++ SH bases of the view direction
  ++ non-rigid feature ++ per-frame latent -> MLP -> sigmoid RGB.
Both read the view direction through `_view_dirs`: rotated back into the
canonical frame when asked to and when a rigid transform exists, then by
the training-time view-noise rotation."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gsavatar_torch import tracing
from gsavatar_torch.core.gaussians import Gaussians
from gsavatar_torch.ops import sh as sh_ops
from gsavatar_torch.utils import transforms as T
from gsavatar_torch.utils.aabb import AABB
from .mlp import VanillaCondMLP


def _view_dirs(gaussians: Gaussians, camera, cano_view_dir: bool,
               view_noise_rot=None):
    """Per-Gaussian unit view directions, rotated back into the canonical
    frame by R_fwd^T when asked to and when a rigid transform exists, then
    by the training-time view-noise rotation `view_noise_rot` (3, 3)."""
    dir_pp = gaussians.get_xyz - camera.camera_center[None, :]
    if cano_view_dir and gaussians.fwd_transform is not None:
        R_bwd = gaussians.fwd_transform[:, :3, :3].transpose(1, 2)
        dir_pp = T.matvec3(R_bwd, dir_pp)
        if view_noise_rot is not None:
            dir_pp = (dir_pp[..., :, None] * view_noise_rot[None]).sum(-2)
    return dir_pp / (torch.linalg.vector_norm(dir_pp, dim=1, keepdim=True)
                     + 1e-12)


class SH2RGB(nn.Module):
    def __init__(self, cano_view_dir: bool = False):
        super().__init__()
        self.cano_view_dir = cano_view_dir

    def forward(self, gaussians: Gaussians, camera, latent_idx=None,
                view_noise_rot=None):
        shs = gaussians.get_features.transpose(1, 2)      # (N, 3, coeffs)
        dirs = _view_dirs(gaussians, camera, self.cano_view_dir,
                          view_noise_rot)
        rgb = sh_ops.eval_sh(gaussians.active_sh_degree, shs, dirs)
        return torch.clamp_min(rgb + 0.5, 0.0)


class ColorMLP(nn.Module):
    def __init__(self, feature_dim: int = 32, use_xyz: bool = False,
                 use_cov: bool = False, use_normal: bool = False,
                 sh_degree: int = 3, cano_view_dir: bool = True,
                 non_rigid_dim: int = 16, latent_dim: int = 16,
                 n_frames: int = 1, aabb: Optional[AABB] = None,
                 mlp_cfg: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_xyz = use_xyz
        self.use_cov = use_cov
        self.use_normal = use_normal
        self.sh_degree = sh_degree
        self.cano_view_dir = cano_view_dir
        self.non_rigid_dim = non_rigid_dim
        self.latent_dim = latent_dim
        if use_xyz:
            # a float buffer, as the JAX package's 'subject' constant
            self.aabb = aabb.copy()
        dim_in = (feature_dim + 3 * use_xyz + 6 * use_cov + 3 * use_normal
                  + ((sh_degree + 1) ** 2 - 1 if sh_degree > 0 else 0)
                  + non_rigid_dim + latent_dim)
        if latent_dim > 0:
            self.latent = nn.Embedding(n_frames, latent_dim)
            with torch.no_grad():
                nn.init.normal_(self.latent.weight, 0.0, 1.0,
                                generator=generator)
        cfg = mlp_cfg or {}
        self.mlp = VanillaCondMLP(
            dim_in=dim_in, dim_cond=0, dim_out=3,
            n_neurons=cfg.get('n_neurons', 64),
            n_hidden_layers=cfg.get('n_hidden_layers', 2),
            skip_in=tuple(cfg.get('skip_in', ())),
            cond_in=tuple(cfg.get('cond_in', ())),
            multires=cfg.get('multires', 0), generator=generator)

    def forward(self, gaussians: Gaussians, camera, latent_idx: int,
                view_noise_rot=None):
        with tracing.span('texture/inputs'):
            x = self._inputs(gaussians, camera, latent_idx, view_noise_rot)
        with tracing.span('texture/mlp'):
            return torch.sigmoid(self.mlp(x))

    def _inputs(self, gaussians: Gaussians, camera, latent_idx: int,
                view_noise_rot):
        """The MLP's input rows: the parts named in the module's
        docstring, joined in that order."""
        feats = gaussians.get_features[..., 0]            # (N, feature_dim)
        n = feats.shape[0]
        parts = [feats]
        if self.use_xyz:
            parts.append(self.aabb.normalize(gaussians.get_xyz, sym=True))
        if self.use_cov:
            parts.append(gaussians.get_covariance())
        if self.use_normal:
            # the rotation's column along the smallest scale
            rot = T.quat_to_rotmat(gaussians.params.rotation)
            amin = torch.argmin(gaussians.params.scaling, dim=1)
            parts.append(torch.gather(
                rot, 2, amin[:, None, None].expand(-1, 3, 1))[..., 0])
        if self.sh_degree > 0:
            dirs = _view_dirs(gaussians, camera, self.cano_view_dir,
                              view_noise_rot)
            parts.append(sh_ops.eval_sh_bases(self.sh_degree, dirs)[:, 1:])
        if self.non_rigid_dim > 0:
            if gaussians.non_rigid_feature is None:
                raise ValueError(
                    f"the texture takes a non-rigid feature of "
                    f"{self.non_rigid_dim} columns, but the non-rigid "
                    f"deformer gives none (the identity deformer without a "
                    f"feature_dim, or hannw_mlp): pair it with a texture of "
                    f"non_rigid_dim 0 (texture=sh)")
            parts.append(gaussians.non_rigid_feature)
        if self.latent_dim > 0:
            parts.append(self.latent.weight[latent_idx][None].expand(
                n, self.latent_dim))
        return torch.cat(parts, dim=1)


def get_texture(cfg: dict, metadata: dict, generator=None):
    name = cfg['name']
    if name in ('sh2rgb', 'sh'):
        return SH2RGB(cano_view_dir=cfg.get('cano_view_dir', False))
    if name == 'mlp':
        n_frames = max(len(metadata.get('frame_dict') or {}), 1)
        return ColorMLP(
            feature_dim=cfg['feature_dim'],
            use_xyz=cfg.get('use_xyz', False),
            use_cov=cfg.get('use_cov', False),
            use_normal=cfg.get('use_normal', False),
            sh_degree=cfg.get('sh_degree', 0),
            cano_view_dir=cfg.get('cano_view_dir', False),
            non_rigid_dim=cfg.get('non_rigid_dim', 0),
            latent_dim=cfg.get('latent_dim', 0), n_frames=n_frames,
            aabb=metadata.get('aabb'),
            mlp_cfg=dict(cfg.get('mlp', {}) or {}), generator=generator)
    raise ValueError(f"unknown texture: {name}")
