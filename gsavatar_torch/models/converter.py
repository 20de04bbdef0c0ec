"""GaussianConverter: the composed avatar model stack.

Counterpart of `gsavatar/models/converter.py`: pose correction updates the
camera, then the non-rigid and rigid deformers move the Gaussians and the
texture decodes their colours. Returns (deformed Gaussians, regularization
terms, colours). At `train=True` the step's random draws (`train.TrainDraws`)
add the pose noise (N(0, pose_noise) on camera.rots, applied when the gate
draw says so) and the view-noise rotation of the texture's view directions.
torch cannot replay `jax.random`, so the draws come from the caller."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gsavatar_torch import tracing
from gsavatar_torch.core.gaussians import Gaussians
from gsavatar_torch.utils.transforms import augm_rot_matrix
from .non_rigid import HashGridNonRigid, get_non_rigid
from .pose_correction import get_pose_correction
from .rigid import get_rigid
from .texture import get_texture


class GaussianConverter(nn.Module):
    def __init__(self, pose_correction: nn.Module, non_rigid: nn.Module,
                 rigid: nn.Module, texture: nn.Module,
                 pose_noise: float = 0.0, view_noise: float = 0.0):
        super().__init__()
        self.pose_correction = pose_correction
        self.non_rigid = non_rigid
        self.rigid = rigid
        self.texture = texture
        self.pose_noise = pose_noise
        self.view_noise = view_noise

    def forward(self, gaussians: Gaussians, camera, iteration: int,
                nr_cache=None, train: bool = False, draws=None):
        loss_reg = {}
        with tracing.span('converter/pose_correction'):
            camera, loss_pose = self.pose_correction(camera, iteration)
        loss_reg.update(loss_pose)

        view_noise_rot = None
        if train and draws is not None:
            if self.pose_noise > 0:
                noise = draws.pose_noise * self.pose_noise
                camera = camera.replace(
                    rots=camera.rots + draws.pose_apply * noise)
            if self.view_noise > 0:
                view_noise_rot = augm_rot_matrix(*draws.view_angles).T

        with tracing.span('converter/non_rigid'):
            deformed, loss_nr = self.non_rigid(gaussians, camera, iteration,
                                               camera.latent_idx,
                                               nr_cache=nr_cache)
        loss_reg.update(loss_nr)
        with tracing.span('converter/rigid'):
            deformed = self.rigid(deformed, camera, iteration)
        with tracing.span('converter/texture'):
            colors = self.texture(deformed, camera, camera.latent_idx,
                                  view_noise_rot=view_noise_rot)
        return deformed, loss_reg, colors

    def skinning_loss(self, pts_norm, gt_weights):
        """The skinning field's distillation loss at surface samples; zero
        for a rigid deformer without a learned field."""
        if hasattr(self.rigid, 'skinning_loss'):
            return self.rigid.skinning_loss(pts_norm, gt_weights)
        return torch.zeros((), device=pts_norm.device)

    def subject_constants(self):
        """The float buffers that the JAX package keeps in the converter's
        'subject' collection: the deformers' AABBs, the nearest-vertex
        deformer's template vertices and skinning weights, and the SMPL
        tables of pose correction. They are not trained, but their
        gradients enter the converter optimizer's global norm there, so the
        training step takes them too (`train.make_grad_fn`)."""
        return {k: b for k, b in self.named_buffers()
                if b.is_floating_point()}


def compute_nr_cache(converter: GaussianConverter, gaussians: Gaussians):
    """The pose-independent part of the non-rigid deformer: the hash-grid
    encoding of the CANONICAL positions, which are frozen outside training.
    Computed once per avatar, it lets every rendered frame skip the table
    gathers. (N, L*F) for the hash-grid variant, None otherwise."""
    nr = converter.non_rigid
    if not isinstance(nr, HashGridNonRigid):
        return None
    return nr.encode(gaussians.get_xyz)


def build_converter(cfg: dict, metadata: dict, assets,
                    generator: Optional[torch.Generator] = None
                    ) -> GaussianConverter:
    """Assemble from a full config (cfg['model'], cfg['pipeline'])."""
    model = cfg['model']
    return GaussianConverter(
        pose_correction=get_pose_correction(model['pose_correction'],
                                            metadata, assets),
        non_rigid=get_non_rigid(model['deformer']['non_rigid'], metadata,
                                generator),
        rigid=get_rigid(model['deformer']['rigid'], metadata, generator),
        texture=get_texture(model['texture'], metadata, generator),
        pose_noise=cfg.get('pipeline', {}).get('pose_noise', 0.0),
        view_noise=model['texture'].get('view_noise', 0.0))
