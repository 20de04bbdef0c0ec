"""Offline motion playback: a trained avatar driven by a motion series,
seen by cameras orbiting it.

Counterpart of `gsavatar/apps/render_series.py` (1_render_series_
recorded.py of the original code): per frame the series' pose fields, a
live camera on the orbit, `render_frame`, then `clip * 255` truncated to
uint8 and written as PNG (`utils/png.py`). The video needs OpenCV
(`motion.streams.save_video_from_frames`) and is written only when
`save_video`."""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from gsavatar_torch import tracing
from gsavatar_torch.camera.live import live_camera
from gsavatar_torch.evaluate import to_uint8
from gsavatar_torch.inference import InferenceScene
from gsavatar_torch.motion.series import MotionSeries
from gsavatar_torch.utils import png


def render_series(scene: InferenceScene, series: MotionSeries, *,
                  out_dir: str, width: int = 512, height: int = 512,
                  orbit: bool = True, radius: float = 2.5,
                  max_frames: Optional[int] = None,
                  save_video: bool = True) -> List[np.ndarray]:
    """The frames (uint8 RGB), each also written as `out_dir/%06d.png`."""
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    n = min(len(series), max_frames) if max_frames else len(series)
    T = np.array([0.0, 0.0, radius], np.float32)
    for i in range(n):
        with tracing.unit(i, 'series/frame'):
            rots, Jtrs, bt = series.camera_pose_fields(i, scene.metadata)
            angle = 2 * np.pi * i / max(n, 1) if orbit else 0.0
            Rcw = np.array([[np.cos(angle), 0, -np.sin(angle)], [0, 1, 0],
                            [np.sin(angle), 0, np.cos(angle)]], np.float32)
            cam = live_camera(Rcw, T, width=width, height=height, rots=rots,
                              Jtrs=Jtrs, bone_transforms=bt, frame_id=i,
                              device=scene.device)
            img = to_uint8(scene.render_frame(cam).render.clamp(0, 1))
            frames.append(img)
            png.write_png(os.path.join(out_dir, f"{i:06d}.png"), img)
    if save_video and frames:
        from gsavatar_torch.motion.streams import save_video_from_frames
        save_video_from_frames(frames, os.path.join(out_dir, "series.mp4"))
    return frames
