"""ZJU-MoCap dataset loader.

Counterpart of `gsavatar/data/zjumocap.py`: the subject directory holds
cam_params.json, one directory of frames (*.jpg) and masks (*.png) per
view and the per-frame SMPL fits (models/*.npz). The split picks views and
a frame slice; the predict split plays an out-of-distribution sequence
(negative frame ids, the first frame of view 1 standing in for its
images); freeview orbits the first camera; the training split's metadata
carries the frame dictionary and, with `train_smpl`, the SMPL parameters
the pose correction starts from. The canonical point cloud (50,000
surface samples by default) is cached as cano_smpl.ply (random_pc.ply
with `random_init`) in the subject directory."""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from gsavatar_torch.ops.sampling import sample_surface
from gsavatar_torch.smpl.body_model import find_assets
from gsavatar_torch.utils import ply as ply_io
from . import base, zju_format
from .base import BaseDataset
from .freeview import freeview_camera

PREDICT_SEQS = ['gBR_sBM_cAll_d04_mBR1_ch05_view1',
                'gBR_sBM_cAll_d04_mBR1_ch06_view1',
                'MPI_Limits-03099-op8_poses_view1',
                'canonical_pose_view1']


class ZJUMoCapDataset(BaseDataset):
    RAW_HW = (1024, 1024)

    def __init__(self, cfg: dict, split: str = 'train', device='cpu',
                 ground_truth: bool = True):
        super().__init__(cfg, split, device, ground_truth)
        self.root_dir = cfg['root_dir']
        self.subject = cfg['subject']
        self.white_bg = bool(cfg['white_background'])
        self.h, self.w = cfg['img_hw']
        self.assets = find_assets(cfg.get('body_models_dir',
                                          'body_models/misc'), 'neutral')

        subject_dir = os.path.join(self.root_dir, self.subject)
        with open(os.path.join(subject_dir, 'cam_params.json')) as f:
            self.cam_params = json.load(f)

        cam_names, frames_cfg = self._split_config(split)
        assert len(cam_names) > 0, "no cameras configured for split"

        if split == 'predict':
            seq = PREDICT_SEQS[int(cfg.get('predict_seq', 0))]
            model_files = sorted(glob.glob(
                os.path.join(subject_dir, seq, '*.npz')))
            frames = list(reversed(range(-len(model_files), 0)))
        else:
            model_files = sorted(glob.glob(
                os.path.join(subject_dir, 'models/*.npz')))
            frames = list(range(len(model_files)))
        self.model_files = model_files

        fsl = base.frame_slice(list(frames_cfg), len(model_files))
        sel_files = model_files[fsl]
        sel_frames = frames[fsl]

        if cfg.get('freeview', False):
            trans = np.load(sel_files[0])['trans'].astype(np.float32)
            self.cam_params = freeview_camera(
                self.cam_params[cam_names[0]], trans)
            cam_names = self.cam_params['all_cam_names']

        use_dummies = split == 'predict' or cfg.get('freeview', False)
        dummy_img = os.path.join(subject_dir, '1', '000000.jpg')
        dummy_mask = os.path.join(subject_dir, '1', '000000.png')
        self.data = []
        for cam_name in cam_names:
            cam_dir = os.path.join(subject_dir, cam_name)
            if not use_dummies:
                img_files = sorted(glob.glob(os.path.join(cam_dir,
                                                          '*.jpg')))[fsl]
                mask_files = sorted(glob.glob(os.path.join(cam_dir,
                                                           '*.png')))[fsl]
            for i, frame_idx in enumerate(sel_frames):
                self.data.append({
                    'cam_name': cam_name,
                    'frame_idx': frame_idx,
                    'img_file': dummy_img if use_dummies else img_files[i],
                    'mask_file': dummy_mask if use_dummies
                    else mask_files[i],
                    'model_file': sel_files[i],
                })

        self.metadata = self._load_metadata(split, sel_frames, sel_files)

    def _split_config(self, split):
        cfg = self.cfg
        if split == 'train':
            return list(cfg['train_views']), list(cfg['train_frames'])
        if split == 'val':
            return list(cfg['val_views']), list(cfg['val_frames'])
        if split == 'test':
            tm = cfg['test_mode']
            return list(cfg['test_views'][tm]), list(cfg['test_frames'][tm])
        if split == 'predict':
            return list(cfg['predict_views']), list(cfg['predict_frames'])
        raise ValueError(split)

    def _load_metadata(self, split, sel_frames, sel_files):
        minimal_shape = base.fix_symmetry(
            np.load(self.model_files[0])['minimal_shape'])
        md = base.canonicalize(minimal_shape, self.assets,
                               padding=base.padding_ratio(self.cfg))
        if split != 'train':
            return md
        md.update({
            'posedirs': self.assets.posedirs,
            'J_regressor': self.assets.J_regressor,
            'cameras_extent': base.ZJU_CAMERAS_EXTENT,
            'frame_dict': {f: i for i, f in enumerate(sel_frames)},
        })
        if self.cfg.get('train_smpl', False):
            md.update(zju_format.load_pose_ground_truth(sel_frames, sel_files))
        return md

    def __len__(self):
        return len(self.data)

    def _get_camera(self, idx):
        rec = self.data[idx]
        cp = self.cam_params[rec['cam_name']]
        return zju_format.build_camera(
            K=np.array(cp['K'], np.float32),
            dist=np.array(cp['D'], np.float32).ravel(),
            R=np.array(cp['R'], np.float32),
            T=np.array(cp['T'], np.float32),
            img_file=rec['img_file'], mask_file=rec['mask_file'],
            model_dict=np.load(rec['model_file']), metadata=self.metadata,
            hw_out=(self.h, self.w), hw_raw=self.RAW_HW,
            white_bg=self.white_bg,
            lanczos=bool(self.cfg.get('lanczos', False)),
            frame_idx=rec['frame_idx'], cam_name=rec['cam_name'],
            frame_dict=self.metadata.get('frame_dict'), device=self.device,
            frames=self.ground_truth)

    def readPointCloud(self, n_points=50_000):
        """(points, colours) of the arena's initial Gaussians: the cached
        ply when it exists, else surface samples (or, with `random_init`,
        uniform points in the AABB), written to the cache."""
        n_points = int(self.cfg.get('n_points', n_points))
        random_init = self.cfg.get('random_init', False)
        ply_path = os.path.join(
            self.root_dir, self.subject,
            'random_pc.ply' if random_init else 'cano_smpl.ply')
        if os.path.exists(ply_path):
            d = ply_io._read_ply(ply_path)[0]
            pts = np.stack([d['x'], d['y'], d['z']], 1).astype(np.float32)
            rgb = np.stack([d['red'], d['green'], d['blue']], 1) / 255.0
            return pts, rgb.astype(np.float32)
        if random_init:
            cmin = self.metadata['coord_min'][None]
            cmax = self.metadata['coord_max'][None]
            u = np.random.rand(n_points, 3)
            xyz = (u * cmin + (1.0 - u) * cmax).astype(np.float32)
        else:
            xyz, _, _ = sample_surface(self.metadata['smpl_verts'],
                                       self.metadata['faces'], n_points)
        try:
            ply_io.save_point_cloud_ply(ply_path, xyz,
                                        np.ones_like(xyz) * 255)
        except OSError:
            pass
        return xyz, np.ones_like(xyz)
