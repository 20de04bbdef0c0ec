"""Custom-dataset build pipeline: a video into a ZJU-format training tree.

Counterpart of `gsavatar/tooling/build_dataset.py`, steps 0-7:

  0. downsample_video           keep every n-th frame
  1. segment_video              person masks (YOLOv8-seg: raises here)
  2. extract_images_and_masks   {idx:06d}.jpg + {idx:06d}.png per frame
  3. generate_camera_params     cam_params.json
  4. extract_smpl_model_data    models/{i:06d}.npz from a CLIFF motion
  5. build_yolo_seg_dataset     images/ + masks/ copies
  6. mask_to_yolo_txt           a mask's polygons in YOLO-seg format
  7. yolo_seg_inference         (YOLOv8-seg: raises here)

Video frames are read and written through `motion/streams.VideoStream` and
`save_video_from_frames`, the port's only OpenCV calls. Everything else is
the port's own code and gives OpenCV's results: the mask's Lanczos-4
resize (`data/image_ops.resize_lanczos4`, on `device`), the quality-95
JPEG (`native.write_jpeg`, the bytes of `cv2.imwrite`), the PNG
(`utils/png.write_png`, the same pixels; its zlib stream may differ from
OpenCV's), and the contours, their simplification and the filled
recovered mask (`utils/contours.py`, `utils/draw.py`). Steps 1 and 7 need
the `ultralytics` package and YOLOv8 weights, which the port does not
run: they raise a RuntimeError that names them."""
from __future__ import annotations

import json
import os
import shutil
from glob import glob
from typing import Optional

import numpy as np
import torch

from gsavatar_torch import native
from gsavatar_torch.camera.live import estimate_focal_length
from gsavatar_torch.data import image_ops
from gsavatar_torch.device import resolve_device
from gsavatar_torch.utils import contours, draw, png


def downsample_video(video_path: str, out_path: str, every: int = 10) -> int:
    """Keep every `every`-th frame; returns the number kept."""
    from gsavatar_torch.motion import streams
    src = streams.VideoStream(video_path)
    try:
        kept = (f for i, f in enumerate(src) if i % every == 0)
        return streams.save_video_from_frames(kept, out_path, src.fps)
    finally:
        src.release()


def segment_video(video_path: str, out_masks_path: str,
                  out_video_path: Optional[str] = None,
                  model_path: str = 'yolov8x-seg.pt', conf: float = 0.5,
                  erode_iterations: int = 3, batch_size: int = 8):
    """Person segmentation over a video (1_segment_video.py): needs
    `ultralytics` and YOLOv8-seg weights. Raises a RuntimeError."""
    try:
        import ultralytics  # type: ignore  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "segment_video needs the `ultralytics` package and YOLOv8-seg "
            "weights, which are not in this image (no network egress). "
            "Generate masks elsewhere or supply them as an .npy stack; the "
            "rest of the pipeline consumes masks from any source.") from e
    raise RuntimeError(
        "segment_video: the port does not run YOLOv8 segmentation "
        "(`ultralytics`); supply the masks as an .npy stack")


def extract_images_and_masks(video_path: str, masks_path: str,
                             dataset_dir: str, cam_name: str = '1',
                             start: int = 0, device=None) -> int:
    """Write per-frame {idx:06d}.jpg + {idx:06d}.png into the ZJU layout,
    skipping frames before `start` and frames whose mask is empty; the
    mask is resized to the frame with Lanczos-4 on `device`. Returns the
    number of frames written."""
    from gsavatar_torch.motion import streams
    device = resolve_device(device)
    mask_data = np.load(masks_path)
    cam_dir = os.path.join(dataset_dir, cam_name)
    os.makedirs(cam_dir, exist_ok=True)
    src = streams.VideoStream(video_path)
    written = 0
    try:
        for idx, frame in enumerate(src):
            if idx >= len(mask_data):
                break
            if idx < start or not np.any(mask_data[idx]):
                continue
            h, w = frame.shape[:2]
            mask = np.where(mask_data[idx], 255, 0).astype(np.uint8)
            mask = image_ops.resize_lanczos4(
                torch.as_tensor(mask, device=device), (h, w)).cpu().numpy()
            name = str(idx).zfill(6)
            native.write_jpeg(os.path.join(cam_dir, f"{name}.jpg"), frame)
            png.write_png(os.path.join(cam_dir, f"{name}.png"), mask)
            written += 1
    finally:
        src.release()
    return written


def generate_camera_params(width: int, height: int, out_path: str,
                           cam_name: str = '1') -> dict:
    """A pinhole cam_params.json with the sqrt(w^2 + h^2) focal
    heuristic."""
    f = estimate_focal_length(height, width)
    K = np.array([[f, 0.0, width / 2], [0.0, f, height / 2], [0, 0, 1]],
                 np.float32)
    data = {cam_name: {'K': K.tolist(),
                       'D': np.zeros((5, 1), np.float32).tolist(),
                       'R': np.eye(3, dtype=np.float32).tolist(),
                       'T': np.zeros((3, 1), np.float32).tolist()},
            'all_cam_names': [cam_name]}
    os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
    with open(out_path, 'w') as fh:
        json.dump(data, fh)
    return data


def extract_smpl_model_data(cliff_npz_path: str, out_models_dir: str,
                            assets, flip_root: bool = True,
                            device=None) -> int:
    """A CLIFF motion npz into per-frame ZJU-format SMPL npz files (the
    root overridden to a pi-about-x flip and the translation zeroed
    unless `flip_root` is False), the LBS on `device`. Returns the number
    of frames. The files hold what the JAX package's hold, which lack the
    `minimal_shape` the ZJU-MoCap loader reads (ROADMAP §3)."""
    from gsavatar_torch.motion.series import MotionSeries
    overrides = {}
    if flip_root:
        overrides['root_orient'] = np.array([np.pi, 0.0, 0.0], np.float32)
        overrides['trans'] = np.zeros(3, np.float32)
    series = MotionSeries(cliff_npz_path, assets, device=device, **overrides)
    os.makedirs(out_models_dir, exist_ok=True)
    for i, params in enumerate(series):
        out = os.path.join(out_models_dir, f"{str(i).zfill(6)}.npz")
        np.savez(out, **params.export())
    return len(series)


def build_yolo_seg_dataset(source_dir: str, dest_dir: str) -> int:
    """Pair up {name}.jpg/{name}.png into images/ + masks/."""
    jpgs = sorted(glob(os.path.join(source_dir, '*.jpg')))
    pngs = sorted(glob(os.path.join(source_dir, '*.png')))
    assert len(jpgs) == len(pngs), (len(jpgs), len(pngs))
    img_dir = os.path.join(dest_dir, 'images')
    mask_dir = os.path.join(dest_dir, 'masks')
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    for jpg, pngf in zip(jpgs, pngs):
        base = os.path.basename(pngf).split('.')[0]
        shutil.copy(jpg, os.path.join(img_dir, base + '.jpg'))
        shutil.copy(pngf, os.path.join(mask_dir, base + '.png'))
    return len(jpgs)


def mask_to_yolo_txt(png_mask_path: str, out_txt_path: str,
                     min_area: float = 10.0,
                     epsilon_frac: float = 0.0003) -> np.ndarray:
    """A binary PNG mask into a YOLO-seg polygon .txt: each outer contour
    of area >= `min_area`, simplified to `epsilon_frac` of its length, as
    one line of normalized (x, y); returns the mask the polygons fill
    (holes are lost: the format has none)."""
    img = png.read_png(png_mask_path, 'gray')
    h, w = img.shape[:2]
    thresh = np.where(img > 254, 255, 0).astype(np.uint8)
    recover = np.zeros((h, w), np.uint8)
    with open(out_txt_path, 'w') as f:
        for contour in contours.find_contours(thresh):
            if contours.contour_area(contour) < min_area:
                continue
            eps = epsilon_frac * contours.arc_length(contour, True)
            approx = contours.approx_poly_dp(contour, eps, True)
            if len(approx) < 3:
                continue
            draw.fill_poly(recover, [approx], 255)
            norm = approx.astype(np.float32) / np.array([w, h], np.float32)
            pts = ' '.join(f"{x:.6f} {y:.6f}" for x, y in norm)
            f.write(f"0 {pts}\n")
    return recover


def yolo_seg_inference(*args, **kwargs):
    """(7_yolo_seg_inference.py): needs `ultralytics` and finetuned
    weights. Raises a RuntimeError."""
    raise RuntimeError(
        "yolo_seg_inference needs ultralytics + finetuned weights (absent "
        "in this image); run segment_video's pipeline where YOLO weights "
        "are available.")
