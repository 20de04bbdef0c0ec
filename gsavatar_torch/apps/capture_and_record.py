"""Capture to a retrainable dataset: a ZJU-MoCap tree rendered from a
trained avatar driven by a motion series.

Counterpart of `gsavatar/apps/capture_and_record.py` (4_capture_and_
record.py of the original code): per frame a live camera at `radius`
in front of the body, `render_frame`, the image written as JPEG
(`native.write_jpeg`, the bytes `cv2.imwrite` writes) and its mask
(`alpha > 0.5` as 255) as PNG under `out_dir/<cam_name>/`, the parsed
SMPL parameters and the subject's `minimal_shape` as
`out_dir/models/%06d.npz`, and `cam_params.json`. The ZJU-MoCap loader
reads the tree back (`data.load_dataset`).

Each frame is parsed once and the npz holds the parameters that were
rendered; the JAX app parses twice, so in accumulate mode its npz's
`trans` is one delta past the rendered pose."""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from gsavatar_torch import native
from gsavatar_torch.camera.live import live_camera
from gsavatar_torch.evaluate import to_uint8
from gsavatar_torch.inference import InferenceScene
from gsavatar_torch.motion.series import MotionSeries
from gsavatar_torch.utils import png


def capture_and_record(scene: InferenceScene, series: MotionSeries, *,
                       out_dir: str, cam_name: str = "1",
                       width: int = 512, height: int = 512,
                       radius: float = 2.5,
                       max_frames: Optional[int] = None) -> str:
    img_dir = os.path.join(out_dir, cam_name)
    model_dir = os.path.join(out_dir, "models")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(model_dir, exist_ok=True)

    Rcw = np.eye(3, dtype=np.float32)
    T = np.array([0.0, 0.0, radius], np.float32)
    K = None
    n = min(len(series), max_frames) if max_frames else len(series)
    for i in range(n):
        params = series.parse(i)
        rots, Jtrs, bt = series.camera_pose_fields(i, scene.metadata, params)
        cam = live_camera(Rcw, T, width=width, height=height, rots=rots,
                          Jtrs=Jtrs, bone_transforms=bt, frame_id=i,
                          device=scene.device)
        K = cam.K
        pkg = scene.render_frame(cam)
        img = to_uint8(pkg.render.clamp(0, 1))
        mask = ((pkg.opacity_render > 0.5).to(torch.uint8) * 255).cpu().numpy()
        native.write_jpeg(os.path.join(img_dir, f"{i:06d}.jpg"), img)
        png.write_png(os.path.join(img_dir, f"{i:06d}.png"), mask)

        payload = params.export()
        payload['minimal_shape'] = scene.metadata['minimal_shape']
        np.savez(os.path.join(model_dir, f"{i:06d}.npz"), **payload)

    cam_params = {cam_name: {
        'K': K.tolist(), 'D': [0, 0, 0, 0, 0],
        'R': Rcw.T.tolist(), 'T': T[:, None].tolist(),
    }, 'all_cam_names': [cam_name]}
    with open(os.path.join(out_dir, 'cam_params.json'), 'w') as f:
        json.dump(cam_params, f)
    return out_dir
