"""Live AR: the avatar, driven by a motion series, rendered over a webcam
feed from the camera pose that an ArUco board gives.

Counterpart of `gsavatar/apps/ar_render.py` (3_ar_render.py of the
original code), split in two: `ar_streams` opens the webcam and the board
tracker (OpenCV), and `ar_loop` renders each (frame, pose) pair: a live
camera `(R^T, t_scale * T)` with the webcam's K, `render_frame`, and the
composite of `body_replace.composite_frame` on the device. `ar_render` is
the two together with the JAX signature; the composites are shown through
OpenCV only when `display`."""
from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from gsavatar_torch.apps.body_replace import composite_frame
from gsavatar_torch.camera.live import live_camera
from gsavatar_torch.inference import InferenceScene
from gsavatar_torch.motion import streams
from gsavatar_torch.motion.series import MotionSeries


def ar_streams(device: int = 0):
    """(the webcam `CameraStream`, the `ChArucoStream` over it)."""
    cam_stream = streams.CameraStream(device=device)
    return cam_stream, streams.ChArucoStream(cam_stream, cam_stream.K)


def ar_loop(scene: InferenceScene, series: MotionSeries,
            frames_and_poses: Iterable[Tuple[np.ndarray, object]],
            K: np.ndarray, *, t_scale: float = 4.0,
            max_frames: Optional[int] = None,
            display: bool = False) -> Iterator[np.ndarray]:
    """The composite (uint8 RGB) of each frame whose pose (R, T) is known,
    the series' frames taken in a cycle; with `display`, each is shown and
    Esc ends the loop."""
    shown = 0
    rc = scene.raster_config
    for frame, pose in frames_and_poses:
        if pose is None:
            continue
        R, T = pose
        i = shown % len(series)
        rots, Jtrs, bt = series.camera_pose_fields(i, scene.metadata)
        cam = live_camera(np.asarray(R).T.astype(np.float32),
                          (t_scale * np.asarray(T)).astype(np.float32), K=K,
                          width=rc.width, height=rc.height, rots=rots,
                          Jtrs=Jtrs, bone_transforms=bt,
                          device=scene.device)
        pkg = scene.render_frame(cam)
        composite = composite_frame(
            pkg.render, pkg.opacity_render,
            torch.as_tensor(frame, device=scene.device)).cpu().numpy()
        if display:
            cv2 = streams.import_cv2('the AR display')
            cv2.imshow('ar', cv2.cvtColor(composite, cv2.COLOR_RGB2BGR))
            if cv2.waitKey(1) == 27:
                return
        yield composite
        shown += 1
        if max_frames and shown >= max_frames:
            return


def ar_render(scene: InferenceScene, series: MotionSeries, *,
              device: int = 0, t_scale: float = 4.0,
              max_frames: Optional[int] = None, display: bool = True):
    """The webcam (index `device`) and its board, then `ar_loop` until
    the feed ends, Esc, or `max_frames` composites."""
    cam_stream, board = ar_streams(device)
    try:
        for _ in ar_loop(scene, series, board, cam_stream.K, t_scale=t_scale,
                         max_frames=max_frames, display=display):
            pass
    finally:
        cam_stream.release()
