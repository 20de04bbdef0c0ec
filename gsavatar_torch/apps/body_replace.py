"""Video body replacement: the avatar, posed by a motion series, rendered
over the frames of a video.

Counterpart of `gsavatar/apps/body_replace.py` (2_body_replace.py of the
original code): per frame a live camera at the origin with the series'
focal length, `render_frame` at the scene's raster size, then on the
device the render and its alpha resized to the frame as `cv2.resize`
resizes float32 (`data.image_ops.resize_linear`) and composited as the
JAX package composites, `alpha * render * 255 + (1 - alpha) * frame` in
float32, truncated to uint8. Frames are written as PNG; the video needs
OpenCV and is written only when `save_video`."""
from __future__ import annotations

import os
from typing import Iterable, List, Optional

import numpy as np
import torch

from gsavatar_torch.camera.live import live_camera
from gsavatar_torch.data.image_ops import resize_linear
from gsavatar_torch.inference import InferenceScene
from gsavatar_torch.motion.series import MotionSeries
from gsavatar_torch.utils import png


def series_K(series: MotionSeries, w: int, h: int) -> np.ndarray:
    """The intrinsics of a (w, h) frame at the series' focal length."""
    f = float(np.atleast_1d(series.focal_l)[0])
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def composite_frame(render: torch.Tensor, alpha: torch.Tensor,
                    frame: torch.Tensor) -> torch.Tensor:
    """The render (H, W, 3) and its alpha (H, W) over a uint8 frame
    (h, w, 3) on the same device: both resized to (h, w), then
    `alpha * render * 255 + (1 - alpha) * frame` truncated to uint8."""
    h, w = frame.shape[:2]
    render = resize_linear(render.clamp(0, 1), (h, w))
    alpha = resize_linear(alpha[..., None], (h, w))[..., None]
    return (alpha * render * 255 + (1 - alpha) * frame.float()).to(
        torch.uint8)


def body_replace(scene: InferenceScene, series: MotionSeries,
                 video_frames: Iterable[np.ndarray], *, out_dir: str,
                 max_frames: Optional[int] = None,
                 save_video: bool = True) -> List[np.ndarray]:
    """The composites (uint8 RGB), each also written as
    `out_dir/%06d.png`; one per frame of `video_frames` (uint8 RGB arrays)
    while the series lasts."""
    os.makedirs(out_dir, exist_ok=True)
    out = []
    rc = scene.raster_config
    for i, frame in enumerate(video_frames):
        if (max_frames and i >= max_frames) or i >= len(series):
            break
        h, w = frame.shape[:2]
        rots, Jtrs, bt = series.camera_pose_fields(i, scene.metadata)
        cam = live_camera(np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32), K=series_K(series, w, h),
                          width=rc.width, height=rc.height, rots=rots,
                          Jtrs=Jtrs, bone_transforms=bt, frame_id=i,
                          device=scene.device)
        pkg = scene.render_frame(cam)
        img = composite_frame(pkg.render, pkg.opacity_render,
                              torch.as_tensor(frame, device=scene.device))
        img = img.cpu().numpy()
        out.append(img)
        png.write_png(os.path.join(out_dir, f"{i:06d}.png"), img)
    if save_video and out:
        from gsavatar_torch.motion.streams import save_video_from_frames
        save_video_from_frames(out, os.path.join(out_dir, "composite.mp4"))
    return out
