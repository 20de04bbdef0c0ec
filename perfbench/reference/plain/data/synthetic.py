# Frozen copy of gsavatar_torch/data/synthetic.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Synthetic avatar dataset.

Counterpart of `gsavatar/data/synthetic.py`: the deterministic synthetic
humanoid, posed over F frames with smooth random joint wiggles, seen by
cameras on a circle. The camera records and metadata follow the JAX
dataset's recipes (same seeds, same normalization), and so does the hidden
target: Gaussians on the body surface, skinned to it, whose render is the
ground truth. The port renders the target with its own rasterizer (K1 on
the card) where the JAX package uses its dense XLA route, so the two
ground truths agree to the render gates, not bit for bit. Cameras carry an
image and a mask only when the dataset is given `gt_device`, the device to
render them on (training); the serving path's cameras carry none."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from perfbench.reference.plain.camera.camera import Camera, make_camera
from perfbench.reference.plain.ops.rasterizer import RasterizeConfig, rasterize
from perfbench.reference.plain.ops.sampling import sample_surface
from perfbench.reference.plain.smpl import lbs as smpl_lbs
from perfbench.reference.plain.smpl.body_model import synthetic_assets
from perfbench.reference.plain.utils.transforms import covariance_from_scaling_rotation
from . import base

FOV = 0.8


class SyntheticDataset:
    def __init__(self, cfg: dict, split: str = 'train', gt_device=None):
        self.cfg = cfg
        self.split = split
        self.gt_device = gt_device
        self._cache: Dict[int, Camera] = {}
        seed = cfg.get('seed', 0)
        self.assets = synthetic_assets(n_verts=cfg.get('n_verts', 2048),
                                       seed=seed)
        self.h, self.w = cfg['img_hw']
        self.metadata = base.canonicalize(self.assets.v_template.copy(),
                                          self.assets,
                                          padding=float(cfg['padding']))

        n_frames_total = cfg['train_frames'][1]
        if split == 'train':
            views = [int(v) for v in cfg['train_views']]
            fsl = base.frame_slice(list(cfg['train_frames']), n_frames_total)
        elif split == 'val':
            views = [int(v) for v in cfg['val_views']]
            fsl = base.frame_slice(list(cfg['val_frames']), n_frames_total)
        elif split in ('test', 'predict'):
            views = [int(v) for v in cfg.get('val_views', ['2'])]
            tf = cfg['test_frames']['view'] if split == 'test' \
                else cfg['predict_frames']
            fsl = base.frame_slice(list(tf), n_frames_total)
        else:
            raise ValueError(split)
        frames = list(range(n_frames_total))[fsl]

        # the smooth pose track is the same for all splits
        pose_rng = np.random.default_rng(seed + 1)
        amp = pose_rng.uniform(0.05, 0.25, size=(23, 3))
        phase = pose_rng.uniform(0, 2 * np.pi, size=(23, 3))
        freq = pose_rng.uniform(0.5, 1.5, size=(23, 3))
        self._poses = []
        for f in range(n_frames_total):
            t = f / max(n_frames_total, 1) * 2 * np.pi
            body = amp * np.sin(freq * t + phase)
            pose = np.concatenate([np.zeros(3), body.reshape(-1)])
            self._poses.append(pose.astype(np.float32))

        self._views = {v: self._make_view(v) for v in sorted(set(views))}
        self.frames = frames
        self.views = views
        self.data = [{'view': v, 'frame': f} for v in views for f in frames]

        self.metadata.update({
            'posedirs': self.assets.posedirs,
            'J_regressor': self.assets.J_regressor,
            'cameras_extent': base.ZJU_CAMERAS_EXTENT,
            'frame_dict': {f: i for i, f in enumerate(frames)},
        })
        if cfg.get('train_smpl', False) and split == 'train':
            self.metadata.update(self._pose_ground_truth(frames))
        self._target = self._build_target(cfg)

    def _make_view(self, v: int, n_around: int = 8):
        """Camera `v` of `n_around` on a circle of radius 2.5, looking at
        the body centre (R stored transposed, as the loaders do)."""
        angle = 2 * np.pi * v / n_around
        center = np.array([0.0, -0.1, 0.0])
        radius = 2.5
        cam_pos = center + radius * np.array(
            [math.sin(angle), 0.15, math.cos(angle)])
        fwd = center - cam_pos
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])  # y-down image convention
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        Rcw = np.stack([right, up2, fwd], axis=0)     # world->cam
        T = -Rcw @ cam_pos
        return {'R': Rcw.T.astype(np.float32), 'T': T.astype(np.float32)}

    def _frame_smpl(self, f: int):
        """Per-frame SMPL products (float32 LBS on the host)."""
        a = self.assets
        pose = self._poses[f]
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
        res = smpl_lbs.lbs(
            torch.zeros((1, 10)), t(pose)[None], t(a.v_template)[None],
            t(a.shapedirs), t(a.posedirs), t(a.J_regressor), a.parents,
            t(a.skinning_weights))
        return {
            'bone_transforms': res[3][0].numpy(),
            'trans': np.zeros(3, np.float32),
            'root_orient': pose[:3],
            'pose_body': pose[3:66],
            'pose_hand': pose[66:72],
        }

    def _pose_ground_truth(self, frames: List[int]):
        ret = {'frames': frames, 'root_orient': [], 'pose_body': [],
               'pose_hand': [], 'trans': [],
               'betas': np.zeros((1, 10), np.float32)}
        for f in frames:
            p = self._poses[f]
            ret['root_orient'].append(p[:3])
            ret['pose_body'].append(p[3:66])
            ret['pose_hand'].append(p[66:72])
            ret['trans'].append(np.zeros(3, np.float32))
        return ret

    def _build_target(self, cfg: dict) -> Dict[str, np.ndarray]:
        """The hidden ground-truth Gaussians in canonical space, with their
        skinning weights, procedural colours and jittered scales."""
        n = cfg.get('n_target_gaussians', 4096)
        md = self.metadata
        pts, face_idx, bary = sample_surface(md['smpl_verts'], md['faces'], n,
                                             seed=cfg.get('seed', 0) + 7)
        weights = (md['skinning_weights'][md['faces'][face_idx]]
                   * bary[..., None]).sum(axis=1)
        p = (pts - pts.min(0)) / (np.ptp(pts, 0) + 1e-6)
        colors = np.stack([
            0.5 + 0.5 * np.sin(3.0 * p[:, 0] + 6.0 * p[:, 1]),
            p[:, 1],
            0.5 + 0.5 * np.cos(5.0 * p[:, 2] + 2.0 * p[:, 1]),
        ], axis=1).astype(np.float32)
        rng = np.random.default_rng(cfg.get('seed', 0) + 13)
        scales = np.full((n, 3), 0.012, np.float32) \
            * (0.7 + 0.6 * rng.random((n, 3), dtype=np.float32))
        return {'xyz': pts.astype(np.float32), 'colors': colors,
                'opacity': np.full((n, 1), 0.9, np.float32),
                'scales': scales.astype(np.float32),
                'weights': weights.astype(np.float32)}

    @torch.no_grad()
    def render_gt(self, camera: Camera, device):
        """The hidden target skinned by the camera's bone transforms and
        rendered on `device` over a black background: (image clipped to
        [0, 1], mask = alpha > 0.5)."""
        t = {k: torch.as_tensor(v, device=device)
             for k, v in self._target.items()}
        cam = camera.to(device)
        T_fwd = (t['weights'] @ cam.bone_transforms.reshape(-1, 16)).reshape(
            -1, 4, 4)
        xyz = (T_fwd[:, :3, :3] @ t['xyz'][..., None])[..., 0] \
            + T_fwd[:, :3, 3]
        q = torch.zeros((xyz.shape[0], 4), device=device)
        q[:, 0] = 1.0
        cov = covariance_from_scaling_rotation(t['scales'], 1.0, q)
        res = rasterize(
            xyz, t['colors'], t['opacity'], cov,
            viewmatrix=cam.world_view_transform,
            full_projmatrix=cam.full_proj_transform, tanfovx=cam.tanfovx,
            tanfovy=cam.tanfovy, background=torch.zeros(3, device=device),
            # a pair cap no render of the target reaches: max_rect^2 tiles
            # for each of its Gaussians
            config=RasterizeConfig(
                width=self.w, height=self.h,
                max_pairs=xyz.shape[0] * RasterizeConfig.max_rect ** 2))
        if res.rect_dropped:
            raise RuntimeError(f"the ground truth of {camera.image_name} "
                               f"drops {res.rect_dropped} tiles")
        return (torch.clamp(res.image, 0.0, 1.0),
                (res.alpha > 0.5).to(torch.float32))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int) -> Camera:
        """The camera of record `idx`; with `gt_device`, on that device and
        carrying its ground truth (rendered once, then cached)."""
        if self.gt_device is None:
            return self._camera(idx)
        if idx not in self._cache:
            cam = self._camera(idx).to(self.gt_device)
            image, mask = self.render_gt(cam, self.gt_device)
            self._cache[idx] = cam.replace(image=image, mask=mask)
        return self._cache[idx]

    def _camera(self, idx: int) -> Camera:
        rec = self.data[idx]
        v, f = rec['view'], rec['frame']
        smpl = self._frame_smpl(f)
        cam_params = self._views[v]
        md = self.metadata
        rots = base.pose_to_rots(smpl['root_orient'], smpl['pose_body'],
                                 smpl['pose_hand'])
        Jtr_norm = base.normalize_Jtr(md['Jtr'], md['minimal_shape'])
        bt = base.compose_bone_transforms(
            smpl['bone_transforms'], md['bone_transforms_02v'], smpl['trans'])
        frame_dict = md['frame_dict']
        li = frame_dict.get(f, max(len(frame_dict) - 1, 0))
        return make_camera(
            R=cam_params['R'], T=cam_params['T'], fovx=FOV, fovy=FOV,
            width=self.w, height=self.h, rots=rots[None],
            Jtrs=Jtr_norm[None], bone_transforms=bt, frame_id=f, cam_id=v,
            image_name=f"c{v:02d}_f{f:06d}", latent_idx=li, pose_idx=li,
            in_frame_dict=float(f in frame_dict))

    def readPointCloud(self, n_points=None):
        """Points on the canonical body surface and white colours."""
        n = n_points or self.cfg.get('n_points', 8192)
        pts, _, _ = sample_surface(self.metadata['smpl_verts'],
                                   self.metadata['faces'], n,
                                   seed=self.cfg.get('seed', 0) + 3)
        return pts, np.ones_like(pts)
