"""PeopleSnapshot dataset loader (monocular, one camera '1').

Counterpart of `gsavatar/data/people_snapshot.py`: intrinsics from
camera.pkl (identity extrinsics), frames in image/*.jpg and masks in
mask/*.png, SMPL fits per frame in animnerf_models/<frame>.npz, the gender
from the subject's name, and predict sequences of SMPL fits over the first
frame's image. Like the JAX package (and unlike the original PeopleSnapshot
recipe, which slices the frame list twice), the frame dictionary is keyed
by the selected frames themselves."""
from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from gsavatar_torch.ops.sampling import sample_surface
from gsavatar_torch.smpl.body_model import find_assets
from . import base, zju_format
from .base import BaseDataset

PREDICT_SEQS = ['rotating_models', 'gLO_sBM_cAll_d14_mLO1_ch05_view1']


class PeopleSnapshotDataset(BaseDataset):
    def __init__(self, cfg: dict, split: str = 'train', device='cpu',
                 ground_truth: bool = True):
        super().__init__(cfg, split, device, ground_truth)
        self.root_dir = cfg['root_dir']
        self.subject = cfg['subject']
        self.white_bg = bool(cfg['white_background'])
        self.h, self.w = cfg['img_hw']

        subject_dir = os.path.join(self.root_dir, self.subject)
        with open(os.path.join(subject_dir, 'camera.pkl'), 'rb') as f:
            camera = pickle.load(f, encoding='latin1')
        self.K, self.R, self.T, self.D = self._get_KRTD(camera)
        self.RAW_HW = (camera['height'], camera['width'])

        gender = 'female' if 'female' in self.subject else 'male'
        self.assets = find_assets(cfg.get('body_models_dir',
                                          'body_models/misc'), gender)

        start, end, step = self._frames_config(split)
        if split == 'predict':
            seq = PREDICT_SEQS[int(cfg.get('predict_seq', 0))]
            model_files = sorted(glob.glob(
                os.path.join(subject_dir, seq, '*.npz')))
            frames = list(reversed(range(-len(model_files), 0)))
            if end == 0:
                end = len(model_files)
            fsl = slice(start, end, step)
            sel_files = model_files[fsl]
            sel_frames = frames[fsl]
        else:
            sel_frames = list(range(start, end, step))
            fsl = slice(start, end, step)
            sel_files = [os.path.join(subject_dir,
                                      f'animnerf_models/{f:06d}.npz')
                         for f in sel_frames]
        self.model_files = sel_files

        img_files = sorted(glob.glob(os.path.join(subject_dir, 'image',
                                                  '*.jpg')))[fsl]
        mask_files = sorted(glob.glob(os.path.join(subject_dir, 'mask',
                                                   '*.png')))[fsl]
        dummy = split == 'predict'
        self.data = [{
            'cam_name': '1', 'frame_idx': frame_idx,
            'img_file': img_files[0] if dummy else img_files[i],
            'mask_file': mask_files[0] if dummy else mask_files[i],
            'model_file': sel_files[i],
        } for i, frame_idx in enumerate(sel_frames)]

        self.metadata = self._load_metadata(split, sel_frames, sel_files)

    @staticmethod
    def _get_KRTD(camera):
        K = np.zeros([3, 3], dtype=np.float32)
        K[0, 0] = camera['camera_f'][0]
        K[1, 1] = camera['camera_f'][1]
        K[:2, 2] = camera['camera_c']
        K[2, 2] = 1
        R = np.eye(3, dtype=np.float32)
        T = np.zeros([3, 1], dtype=np.float32)
        D = np.asarray(camera['camera_k'], np.float32)
        return K, R, T, D

    def _frames_config(self, split):
        cfg = self.cfg
        if split == 'train':
            return list(cfg['train_frames'])
        if split == 'val':
            return list(cfg['val_frames'])
        if split == 'test':
            return list(cfg['test_frames'][cfg['test_mode']])
        if split == 'predict':
            return list(cfg['predict_frames'])
        raise ValueError(split)

    def _load_metadata(self, split, sel_frames, sel_files):
        minimal_shape = base.fix_symmetry(
            np.load(sel_files[0])['minimal_shape'])
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
        return zju_format.build_camera(
            K=self.K, dist=self.D, R=self.R, T=self.T,
            img_file=rec['img_file'], mask_file=rec['mask_file'],
            model_dict=np.load(rec['model_file']), metadata=self.metadata,
            hw_out=(self.h, self.w), hw_raw=self.RAW_HW,
            white_bg=self.white_bg,
            lanczos=bool(self.cfg.get('lanczos', False)),
            frame_idx=rec['frame_idx'], cam_name=rec['cam_name'],
            frame_dict=self.metadata.get('frame_dict'), device=self.device,
            frames=self.ground_truth)

    def readPointCloud(self, n_points=50_000):
        """(points, white colours): surface samples, or with `random_init`
        uniform points in the AABB."""
        n_points = int(self.cfg.get('n_points', n_points))
        if self.cfg.get('random_init', False):
            cmin = self.metadata['coord_min'][None]
            cmax = self.metadata['coord_max'][None]
            u = np.random.rand(n_points, 3)
            xyz = (u * cmin + (1.0 - u) * cmax).astype(np.float32)
        else:
            xyz, _, _ = sample_surface(self.metadata['smpl_verts'],
                                       self.metadata['faces'], n_points)
        return xyz, np.ones_like(xyz)
