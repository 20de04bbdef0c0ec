"""Frame sources of the real-time apps: video files, a webcam, and the
camera pose from an ArUco board.

Counterpart of `gsavatar/motion/streams.py` (motion_display/
{video_stream,camera_stream,charuco_stream}.py of the original code).
These wrap OpenCV's video I/O and ArUco detection, which the port does not
reimplement: each imports cv2 when it is used, and raises an ImportError
that names what needs it where cv2 is missing. Nothing of the render path
goes through them."""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from gsavatar_torch.camera.live import default_K


def import_cv2(what: str):
    """OpenCV, or an ImportError saying that `what` needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{what} needs OpenCV (cv2), which is not installed; the port "
            f"has no video codec or ArUco detector of its own") from e
    return cv2


class VideoStream:
    """Frames of a video file (RGB uint8) with CLIFF-style intrinsics
    (video_stream.py:10-92)."""

    def __init__(self, path: str, focal: Optional[float] = None):
        cv2 = import_cv2('VideoStream')
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise FileNotFoundError(path)
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.n_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.K = default_K(self.width, self.height)
        if focal:
            self.K[0, 0] = self.K[1, 1] = focal

    def __len__(self):
        return self.n_frames

    def __iter__(self) -> Iterator[np.ndarray]:
        cv2 = import_cv2('VideoStream')
        while True:
            ok, frame = self.cap.read()
            if not ok:
                break
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def release(self):
        self.cap.release()


class CameraStream:
    """Webcam frames (RGB uint8); needs a video device
    (camera_stream.py:41-97)."""

    def __init__(self, device: int = 0, width: int = 1280, height: int = 720,
                 focal: Optional[float] = None):
        cv2 = import_cv2('CameraStream')
        self.cap = cv2.VideoCapture(device)
        if not self.cap.isOpened():
            raise RuntimeError(f"no camera at index {device}")
        self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        self.width, self.height = width, height
        self.K = default_K(width, height)
        if focal:
            self.K[0, 0] = self.K[1, 1] = focal

    def __iter__(self):
        cv2 = import_cv2('CameraStream')
        while True:
            ok, frame = self.cap.read()
            if not ok:
                break
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def release(self):
        self.cap.release()


class ChArucoStream:
    """The camera's pose against an ArUco GridBoard in each frame of a
    source (charuco_stream.py:31-82): markers detected, the board's pose
    solved, the last pose kept when the board is not seen."""

    def __init__(self, source, K: np.ndarray, dist=None,
                 markers_x: int = 5, markers_y: int = 7,
                 marker_len: float = 0.04, marker_sep: float = 0.01):
        cv2 = import_cv2('ChArucoStream')
        self.source = source
        self.K = K
        self.dist = np.zeros(5, np.float32) if dist is None else dist
        adict = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_6X6_250)
        self.board = cv2.aruco.GridBoard(
            (markers_x, markers_y), marker_len, marker_sep, adict)
        self.detector = cv2.aruco.ArucoDetector(adict)
        self._last: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def detect(self, frame_rgb: np.ndarray):
        """(R (3, 3), T (3,)) of the camera against the board, or the last
        pose when the board is not visible (None before the first)."""
        cv2 = import_cv2('ChArucoStream')
        gray = cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2GRAY)
        corners, ids, _ = self.detector.detectMarkers(gray)
        if ids is not None and len(ids) > 0:
            obj_pts, img_pts = self.board.matchImagePoints(corners, ids)
            if obj_pts is not None and len(obj_pts) >= 4:
                ok, rvec, tvec = cv2.solvePnP(obj_pts, img_pts, self.K,
                                              self.dist)
                if ok:
                    R, _ = cv2.Rodrigues(rvec)
                    self._last = (R, tvec.ravel())
        return self._last

    def __iter__(self):
        for frame in self.source:
            yield frame, self.detect(frame)


def save_video_from_frames(frames, path: str, fps: float = 30.0) -> int:
    """An MP4 (mp4v) of RGB uint8 frames, a sequence or any iterable, at
    the first frame's size (utils/io_utils.py:4-16); returns the number of
    frames written. No frame, no file."""
    cv2 = import_cv2('save_video_from_frames')
    vw, n = None, 0
    for f in frames:
        if vw is None:
            os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
            h, w = f.shape[:2]
            vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), fps,
                                 (w, h))
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        n += 1
    if vw is not None:
        vw.release()
    return n
