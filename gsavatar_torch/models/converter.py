"""GaussianConverter: the composed avatar model stack, at eval.

Counterpart of `gsavatar/models/converter.py` with `train=False`: pose
correction updates the camera, then the non-rigid and rigid deformers move
the Gaussians and the texture decodes their colours. Returns (deformed
Gaussians, regularization terms, colours). The training-time pose and
view noise come with the training slice."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gsavatar_torch.core.gaussians import Gaussians
from .non_rigid import HashGridNonRigid, get_non_rigid
from .pose_correction import get_pose_correction
from .rigid import get_rigid
from .texture import get_texture


class GaussianConverter(nn.Module):
    def __init__(self, pose_correction: nn.Module, non_rigid: nn.Module,
                 rigid: nn.Module, texture: nn.Module):
        super().__init__()
        self.pose_correction = pose_correction
        self.non_rigid = non_rigid
        self.rigid = rigid
        self.texture = texture

    def forward(self, gaussians: Gaussians, camera, iteration: int,
                nr_cache=None):
        loss_reg = {}
        camera, loss_pose = self.pose_correction(camera, iteration)
        loss_reg.update(loss_pose)
        deformed, loss_nr = self.non_rigid(gaussians, camera, iteration,
                                           camera.latent_idx,
                                           nr_cache=nr_cache)
        loss_reg.update(loss_nr)
        deformed = self.rigid(deformed, camera, iteration)
        colors = self.texture(deformed, camera, camera.latent_idx)
        return deformed, loss_reg, colors


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
    """Assemble from a full config (cfg['model'])."""
    model = cfg['model']
    return GaussianConverter(
        pose_correction=get_pose_correction(model['pose_correction'],
                                            metadata, assets),
        non_rigid=get_non_rigid(model['deformer']['non_rigid'], metadata,
                                generator),
        rigid=get_rigid(model['deformer']['rigid'], metadata, generator),
        texture=get_texture(model['texture'], metadata, generator))
