"""Pose-conditioned non-rigid deformers.

Counterpart of `gsavatar/models/non_rigid.py`: the identity, MLP,
Hann-window MLP and hash-grid variants, selected by `cfg['name']`, with
their helpers `_apply_deltas` and `_reg`. Offsets: xyz additive; scale
'logit' (additive on log-scale), 'exp' (additive on the scale) or 'zero';
rotation 'add' (additive on the unnormalised quaternion, which
`Gaussians.get_covariance` normalises) or 'mult' (quaternion product with
the delta's w pinned to 1). Before `delay` the deltas are multiplied by a
zero gate, which is the identity for every mode; the Hann-window variant
zeroes its deltas before `kick_in_iter` instead."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gsavatar_torch import tracing
from gsavatar_torch.core.gaussians import Gaussians
from gsavatar_torch.utils import transforms as T
from gsavatar_torch.utils.aabb import AABB
from .hashgrid import HashGrid
from .mlp import HannwCondMLP, cond_mlp_from_cfg
from .pose_encoder import HierarchicalPoseEncoder


def _apply_deltas(gaussians: Gaussians, delta_xyz, delta_scale, delta_rot,
                  scale_offset: str, rot_offset: str, gate: float):
    p = gaussians.params
    delta_xyz = gate * delta_xyz
    new_xyz = p.xyz + delta_xyz

    if scale_offset == 'logit':
        delta_scale = gate * delta_scale
        new_scaling = p.scaling + delta_scale
    elif scale_offset == 'exp':
        delta_scale = gate * delta_scale
        new_scaling = torch.log(torch.clamp_min(
            torch.exp(p.scaling) + delta_scale, 1e-6))
    elif scale_offset == 'zero':
        delta_scale = torch.zeros_like(delta_scale)
        new_scaling = p.scaling
    else:
        raise ValueError(f"unknown scale offset {scale_offset!r}")

    if rot_offset == 'add':
        delta_rot = gate * delta_rot
        new_rotation = p.rotation + delta_rot
    elif rot_offset == 'mult':
        # gate == 0 gives the identity quaternion [1, 0, 0, 0]
        q1 = torch.cat([torch.ones_like(delta_rot[:, :1]),
                        gate * delta_rot[:, 1:]], dim=1)
        delta_rot = q1[:, 1:]          # the regularized part
        new_rotation = T.quat_multiply(q1, p.rotation)
    else:
        raise ValueError(f"unknown rotation offset {rot_offset!r}")

    out = gaussians.replace(params=p.replace(
        xyz=new_xyz, scaling=new_scaling, rotation=new_rotation))
    return out, delta_xyz, delta_scale, delta_rot


def _reg(delta_xyz, delta_scale, delta_rot, alive):
    """Means over alive slots. The L2 norm carries an epsilon so that its
    gradient is defined at exactly-zero deltas."""
    n = torch.clamp_min(alive.sum(), 1.0)
    l2 = torch.sqrt((delta_xyz * delta_xyz).sum(1) + 1e-20)
    return {
        'nr_xyz': (alive * l2).sum() / n,
        'nr_scale': (alive * delta_scale.abs().sum(1)).sum() / n,
        'nr_rot': (alive * delta_rot.abs().sum(1)).sum() / n,
    }


def make_hashgrid(hg: dict, generator=None) -> HashGrid:
    return HashGrid(
        n_levels=hg.get('n_levels', 16),
        n_features_per_level=hg.get('n_features_per_level', 2),
        log2_hashmap_size=hg.get('log2_hashmap_size', 16),
        base_resolution=hg.get('base_resolution', 16),
        max_resolution=hg.get('max_resolution', 2048),
        per_level_scale=hg.get('per_level_scale', 0.0),
        generator=generator)


class IdentityNonRigid(nn.Module):
    """No deformation and no regularizer; a zero non-rigid feature of
    `feature_dim` columns when that is > 0."""

    def __init__(self, feature_dim: int = 0):
        super().__init__()
        self.feature_dim = feature_dim

    def forward(self, gaussians: Gaussians, camera, iteration: int,
                latent_idx: int, nr_cache=None):
        if self.feature_dim > 0:
            xyz = gaussians.params.xyz
            gaussians = gaussians.replace(non_rigid_feature=torch.zeros(
                (xyz.shape[0], self.feature_dim), device=xyz.device))
        return gaussians, {}


class _CondDeformBase(nn.Module):
    """The latent and pose conditioning of the MLP and hash-grid variants,
    their AABB (a float buffer: its gradient counts in the converter
    optimizer's clip norm, as the JAX package's 'subject' constant does)
    and their offsets."""

    def __init__(self, aabb: AABB, latent_dim: int = 0, n_frames: int = 1,
                 feature_dim: int = 0, delay: int = 0,
                 scale_offset: str = 'logit', rot_offset: str = 'mult',
                 pose_encoder_cfg: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aabb = aabb.copy()
        self.latent_dim = latent_dim
        self.feature_dim = feature_dim
        self.delay = delay
        self.scale_offset = scale_offset
        self.rot_offset = rot_offset
        pe = pose_encoder_cfg or {}
        self.pose_encoder = HierarchicalPoseEncoder(
            num_joints=pe.get('num_joints', 24),
            rel_joints=pe.get('rel_joints', False),
            dim_per_joint=pe.get('dim_per_joint', 6),
            out_dim=pe.get('out_dim', -1), generator=generator)
        if latent_dim > 0:
            self.latent = nn.Embedding(n_frames, latent_dim)
            with torch.no_grad():
                nn.init.normal_(self.latent.weight, 0.0, 1.0,
                                generator=generator)

    @property
    def cond_dim(self) -> int:
        return self.pose_encoder.n_output_dims + self.latent_dim

    def _pose_feat(self, camera, latent_idx: int):
        with tracing.span('non_rigid/pose_code'):
            feat = self.pose_encoder(camera.rots, camera.Jtrs)  # (1, D)
            if self.latent_dim > 0:
                feat = torch.cat(
                    [feat, self.latent.weight[latent_idx][None]], dim=1)
            return feat

    def _finish(self, gaussians, deltas, iteration: int):
        gate = float(iteration >= self.delay)
        out, dx, ds, dr = _apply_deltas(
            gaussians, deltas[:, :3], deltas[:, 3:6], deltas[:, 6:10],
            self.scale_offset, self.rot_offset, gate)
        if self.feature_dim > 0:
            out = out.replace(non_rigid_feature=gate * deltas[:, 10:])
        return out, _reg(dx, ds, dr, gaussians.alive.float())


class MLPNonRigid(_CondDeformBase):
    """The pose-conditioned MLP on the normalised canonical positions."""

    def __init__(self, mlp_cfg: dict, **kw):
        super().__init__(**kw)
        self.mlp = cond_mlp_from_cfg(3, self.cond_dim, 10 + self.feature_dim,
                                     mlp_cfg, kw.get('generator'))

    def forward(self, gaussians: Gaussians, camera, iteration: int,
                latent_idx: int, nr_cache=None):
        pose_feat = self._pose_feat(camera, latent_idx)
        with tracing.span('non_rigid/mlp'):
            xyz_norm = self.aabb.normalize(gaussians.get_xyz, sym=True)
            deltas = self.mlp(xyz_norm, cond=pose_feat)
        return self._finish(gaussians, deltas, iteration)


class HashGridNonRigid(_CondDeformBase):
    def __init__(self, mlp_cfg: dict, hashgrid_cfg: dict, **kw):
        super().__init__(**kw)
        self.hashgrid = make_hashgrid(hashgrid_cfg, kw.get('generator'))
        self.mlp = cond_mlp_from_cfg(
            self.hashgrid.n_output_dims, self.cond_dim,
            10 + self.feature_dim, mlp_cfg, kw.get('generator'))

    def encode(self, xyz):
        """Hash-grid features of canonical positions (N, 3) -> (N, L*F)."""
        return self.hashgrid(self.aabb.normalize(xyz, sym=True))

    def forward(self, gaussians: Gaussians, camera, iteration: int,
                latent_idx: int, nr_cache=None):
        """`nr_cache` is `encode` of the canonical positions, which are
        frozen outside training: the render path computes it once per
        avatar (converter.compute_nr_cache) and skips the table gathers."""
        pose_feat = self._pose_feat(camera, latent_idx)
        feature = nr_cache if nr_cache is not None \
            else self.encode(gaussians.get_xyz)
        deltas = self.mlp(feature, cond=pose_feat)
        return self._finish(gaussians, deltas, iteration)


class HannwMLPNonRigid(_CondDeformBase):
    """The Hann-window annealed MLP: deltas zeroed before `kick_in_iter`,
    the rotation delta the last four columns, no non-rigid feature."""

    def __init__(self, mlp_cfg: dict, kick_in_iter: int = 3000,
                 full_band_iter: int = 10000, **kw):
        super().__init__(**kw)
        self.kick_in_iter = kick_in_iter
        self.mlp = HannwCondMLP(
            dim_in=3, dim_cond=self.cond_dim, dim_out=10,
            n_neurons=mlp_cfg['n_neurons'],
            n_hidden_layers=mlp_cfg['n_hidden_layers'],
            kick_in_iter=kick_in_iter, full_band_iter=full_band_iter,
            skip_in=tuple(mlp_cfg.get('skip_in', ())),
            cond_in=tuple(mlp_cfg.get('cond_in', ())),
            multires=mlp_cfg.get('multires', 0),
            generator=kw.get('generator'))

    def forward(self, gaussians: Gaussians, camera, iteration: int,
                latent_idx: int, nr_cache=None):
        pose_feat = self._pose_feat(camera, latent_idx)
        with tracing.span('non_rigid/mlp'):
            xyz_norm = self.aabb.normalize(gaussians.get_xyz, sym=True)
            deltas = self.mlp(xyz_norm, iteration, cond=pose_feat)
        deltas = deltas * float(iteration >= self.kick_in_iter)
        out, dx, ds, dr = _apply_deltas(
            gaussians, deltas[:, :3], deltas[:, 3:6], deltas[:, -4:],
            self.scale_offset, self.rot_offset, 1.0)
        return out, _reg(dx, ds, dr, gaussians.alive.float())


def get_non_rigid(cfg: dict, metadata: dict, generator=None):
    """The deformer `cfg['name']` names, with the JAX package's defaults
    for the keys a config omits."""
    name = cfg['name']
    if name == 'identity':
        return IdentityNonRigid(feature_dim=cfg.get('feature_dim', 0))
    n_frames = max(len(metadata.get('frame_dict') or {}), 1)
    common = dict(aabb=metadata['aabb'], latent_dim=cfg.get('latent_dim', 0),
                  n_frames=n_frames, feature_dim=cfg.get('feature_dim', 0),
                  delay=cfg.get('delay', 0),
                  scale_offset=cfg.get('scale_offset', 'logit'),
                  rot_offset=cfg.get('rot_offset', 'add'),
                  pose_encoder_cfg=dict(cfg.get('pose_encoder', {}) or {}),
                  generator=generator)
    if name == 'mlp':
        return MLPNonRigid(mlp_cfg=dict(cfg['mlp']), **common)
    if name == 'hashgrid':
        return HashGridNonRigid(mlp_cfg=dict(cfg['mlp']),
                                hashgrid_cfg=dict(cfg['hashgrid']), **common)
    if name == 'hannw_mlp':
        emb = cfg['mlp']['embedder']
        return HannwMLPNonRigid(mlp_cfg=dict(cfg['mlp']),
                                kick_in_iter=emb['kick_in_iter'],
                                full_band_iter=emb['full_band_iter'],
                                **common)
    raise ValueError(f"unknown non-rigid deformer: {name}")
