"""The plain reference of one playback frame.

A frozen copy of the serving path of `gsavatar_torch`
(`motion/series.py:MotionSeries.parse` and `camera_pose_fields`,
`camera/live.py:live_camera`, `inference.py:InferenceScene.render_frame`)
over the plain modules of `plain/`: the SMPL LBS, the converter at eval
on its own hash-grid cache, and the rasterizer with the plain compositor.
It builds its own converter and canonical body from the configuration and
the subject, and takes from the benchmark only the weights and the motion
arrays."""
from __future__ import annotations

import numpy as np
import torch

from .plain.camera.live import live_camera
from .plain.core import gaussians as G
from .plain.data import base as data_base
from .plain.models.converter import build_converter, compute_nr_cache
from .plain.ops.rasterizer import RasterizeConfig
from .plain.renderer import render
from .plain.smpl import lbs as smpl_lbs


def orbit_rotation(angle: float) -> np.ndarray:
    """`apps/render_series.py`'s camera rotation about the vertical axis."""
    return np.array([[np.cos(angle), 0, -np.sin(angle)], [0, 1, 0],
                     [np.sin(angle), 0, np.cos(angle)]], np.float32)


class RefPlayback:
    """The avatar of the given weights, rendered as `InferenceScene` renders
    it: at the configuration's last iteration and full SH degree, over the
    alive prefix, on the configured background."""

    def __init__(self, cfg: dict, subject, conv_weights, arena, alive,
                 device):
        self.device = torch.device(device)
        self.metadata = subject.metadata
        a = subject.assets
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                      device=self.device)
        self._smpl = (t(a.v_template)[None], t(a.shapedirs), t(a.posedirs),
                      t(a.J_regressor), [int(p) for p in a.parents],
                      t(a.skinning_weights))
        g = cfg['model']['gaussian']
        self.use_sh = bool(g['use_sh'])
        self.max_sh = int(g['sh_degree'])
        self.iteration = int(cfg['opt']['iterations'])
        h, w = cfg['dataset']['img_hw']
        r = cfg['rasterizer']
        self.raster = RasterizeConfig(width=int(w), height=int(h),
                                      max_pairs=int(r['max_pairs']),
                                      max_rect=int(r['max_rect']))
        white = cfg['dataset'].get('white_background', False)
        self.background = torch.full((3,), 1.0 if white else 0.0,
                                     device=self.device)
        self.converter = build_converter(cfg, self.metadata, a)
        self.converter.load_state_dict(conv_weights)
        self.converter.to(self.device).eval()
        params = G.GaussianParams(**arena)
        n = int(alive.sum())
        bucket = n if bool(alive[:n].all()) else 0
        aux = G.GaussianAux(alive=alive, max_radii2d=None,
                            xyz_gradient_accum=None, denom=None, nn_ix=None)
        self.view = G.make_view(
            params, aux, active_sh_degree=self.max_sh if self.use_sh else 0,
            max_sh_degree=self.max_sh, use_sh=self.use_sh, bucket=bucket)
        with torch.inference_mode():
            self.nr_cache = compute_nr_cache(self.converter, self.view)

    @torch.inference_mode()
    def pose_fields(self, pose, shape, trans):
        """(rots, Jtrs, bone_transforms) of one motion frame."""
        v_template, shapedirs, posedirs, J_regressor, parents, weights = \
            self._smpl
        _, _, _, A, _, _, _, _ = smpl_lbs.lbs(
            torch.as_tensor(shape, device=self.device)[None],
            torch.as_tensor(pose, device=self.device)[None], v_template,
            shapedirs, posedirs, J_regressor, parents, weights)
        md = self.metadata
        rots = data_base.pose_to_rots(pose[:3], pose[3:66], pose[66:72])
        Jtr = data_base.normalize_Jtr(md['Jtr'], md['minimal_shape'])
        bt = data_base.compose_bone_transforms(
            A[0].cpu().numpy(), md['bone_transforms_02v'], trans)
        return rots[None], Jtr[None], bt

    @torch.inference_mode()
    def frame(self, k: int, motion: dict, orbit_frames: int, radius: float):
        """Frame k of the playback loop: its camera and render."""
        i = k % len(motion['pose'])
        rots, jtrs, bt = self.pose_fields(motion['pose'][i],
                                          motion['shape'][i],
                                          motion['global_t'][i])
        angle = 2 * np.pi * (k % orbit_frames) / orbit_frames
        cam = live_camera(orbit_rotation(angle),
                          np.array([0.0, 0.0, radius], np.float32),
                          width=self.raster.width, height=self.raster.height,
                          rots=rots, Jtrs=jtrs, bone_transforms=bt,
                          frame_id=k, device=self.device)
        pkg = render(self.converter, self.view, cam, self.iteration,
                     self.raster, self.background, nr_cache=self.nr_cache)
        return cam, pkg
