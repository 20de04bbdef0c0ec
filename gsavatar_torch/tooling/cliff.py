"""CLIFF-input preprocessing math (the SPIN-lineage crop pipeline).

Counterpart of `gsavatar/tooling/cliff.py`. The crop geometry, the bbox
convention, the 6D rotation and the camera conversion are the same float64
numpy. `crop` resizes with `data/image_ops.resize_linear`, which computes
`cv2.resize`'s float32 `INTER_LINEAR` result bit for bit at any scale; the
frame readers are the port's JPEG and PNG decoders, and the video writer is
`motion/streams.save_video_from_frames`."""
from __future__ import annotations

import glob
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gsavatar_torch.data import image_ops

# crop geometry and ImageNet normalization
CROP_IMG_HEIGHT = 256
CROP_IMG_WIDTH = 192
CROP_ASPECT_RATIO = CROP_IMG_HEIGHT / float(CROP_IMG_WIDTH)
IMG_NORM_MEAN = (0.485, 0.456, 0.406)
IMG_NORM_STD = (0.229, 0.224, 0.225)


def get_transform(center, scale, res, rot: float = 0.0) -> np.ndarray:
    """3x3 pixel transform mapping full-image coords into a (res[0], res[1])
    crop whose extent is 200*scale pixels tall."""
    h = 200.0 * float(scale)
    w = h / (res[0] / float(res[1]))
    t = np.zeros((3, 3))
    t[0, 0] = res[1] / w
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-float(center[0]) / w + 0.5)
    t[1, 2] = res[0] * (-float(center[1]) / h + 0.5)
    t[2, 2] = 1.0
    if rot != 0:
        rot_rad = -rot * np.pi / 180.0
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat = np.eye(3)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        t_mat = np.eye(3)
        t_mat[:2, 2] = [-res[1] / 2.0, -res[0] / 2.0]
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def transform(pt, center, scale, res, invert: bool = False,
              rot: float = 0.0) -> np.ndarray:
    """Map a 1-based pixel location through the crop transform."""
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = t @ np.array([pt[0] - 1.0, pt[1] - 1.0, 1.0])
    return np.array([round(new_pt[0]), round(new_pt[1])], dtype=int) + 1


def crop(img: np.ndarray, center, scale, res) -> Tuple[np.ndarray,
                                                       np.ndarray,
                                                       np.ndarray]:
    """Crop (zero outside the image) and resize to res = (rows, cols);
    returns (crop float32, ul, br)."""
    ul = np.array(transform([1, 1], center, scale, res, invert=True)) - 1
    br = np.array(transform([res[1] + 1, res[0] + 1], center, scale, res,
                            invert=True)) - 1
    new_shape = [br[1] - ul[1], br[0] - ul[0]]
    if img.ndim > 2:
        new_shape.append(img.shape[2])
    new_img = np.zeros(new_shape, dtype=np.float32)
    new_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    old_x = max(0, ul[0]), min(img.shape[1], br[0])
    old_y = max(0, ul[1]), min(img.shape[0], br[1])
    if new_y[1] > new_y[0] and new_x[1] > new_x[0]:
        new_img[new_y[0]:new_y[1], new_x[0]:new_x[1]] = \
            img[old_y[0]:old_y[1], old_x[0]:old_x[1]]
    out = image_ops.resize_linear(torch.from_numpy(new_img),
                                  (res[0], res[1]))
    return out.numpy(), ul, br


def bbox_from_detector(bbox: Sequence[float],
                       rescale: float = 1.1) -> Tuple[np.ndarray, float]:
    """[min_x, min_y, max_x, max_y] -> (center, scale) with the 200-px
    convention."""
    center = np.array([(bbox[0] + bbox[2]) / 2.0, (bbox[1] + bbox[3]) / 2.0])
    bbox_w = bbox[2] - bbox[0]
    bbox_h = bbox[3] - bbox[1]
    scale = max(bbox_w * CROP_ASPECT_RATIO, bbox_h) / 200.0 * rescale
    return center, scale


def process_image(orig_img_rgb: np.ndarray, bbox: Optional[Sequence[float]],
                  crop_height: int = CROP_IMG_HEIGHT,
                  crop_width: int = CROP_IMG_WIDTH):
    """Crop around the detection (or the image centre) and ImageNet-
    normalize to CHW for the pose estimator; returns (CHW, center, scale,
    ul, br, the crop before normalization)."""
    if bbox is not None:
        center, scale = bbox_from_detector(bbox)
    else:
        height, width = orig_img_rgb.shape[:2]
        center = np.array([width // 2, height // 2])
        scale = max(height, width * crop_height / float(crop_width)) / 200.0
    img, ul, br = crop(orig_img_rgb, center, scale, (crop_height, crop_width))
    crop_img = img.copy()
    img = img / 255.0
    norm = (img - np.asarray(IMG_NORM_MEAN, np.float32)) \
        / np.asarray(IMG_NORM_STD, np.float32)
    return np.transpose(norm, (2, 0, 1)), center, scale, ul, br, crop_img


def rot6d_to_rotmat(x: np.ndarray) -> np.ndarray:
    """(B, 6) continuous 6D rotation -> (B, 3, 3) (Zhou et al., CVPR
    2019)."""
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = a1 / np.maximum(np.linalg.norm(a1, axis=1, keepdims=True), 1e-8)
    a2p = a2 - np.sum(b1 * a2, axis=1, keepdims=True) * b1
    b2 = a2p / np.maximum(np.linalg.norm(a2p, axis=1, keepdims=True), 1e-8)
    b3 = np.cross(b1, b2)
    return np.stack((b1, b2, b3), axis=-1)


def cam_crop2full(crop_cam: np.ndarray, center: np.ndarray, scale: np.ndarray,
                  full_img_shape: np.ndarray,
                  focal_length: np.ndarray) -> np.ndarray:
    """Weak-perspective crop camera (s, tx, ty) -> full-image translation."""
    img_h, img_w = full_img_shape[:, 0], full_img_shape[:, 1]
    cx, cy, b = center[:, 0], center[:, 1], scale * 200.0
    bs = b * crop_cam[:, 0] + 1e-9
    tz = 2.0 * focal_length / bs
    tx = 2.0 * (cx - img_w / 2.0) / bs + crop_cam[:, 1]
    ty = 2.0 * (cy - img_h / 2.0) / bs + crop_cam[:, 2]
    return np.stack([tx, ty, tz], axis=-1)


def video_to_images(vid_file: str, img_folder: str):
    """Dump a video's frames as `%06d.png` with ffmpeg (a FileNotFoundError
    where there is no ffmpeg)."""
    import subprocess
    os.makedirs(img_folder, exist_ok=True)
    subprocess.call(['ffmpeg', '-i', vid_file, '-f', 'image2', '-v', 'error',
                     f'{img_folder}/%06d.png'])


def images_to_video(img_dir: str, video_path: str, frame_rate: float = 30.0):
    """An MP4 of the directory's JPEG, then PNG frames, in sorted order."""
    from gsavatar_torch.data.zju_format import read_image
    from gsavatar_torch.motion import streams
    img_list = sorted(glob.glob(os.path.join(img_dir, '*.jpg'))
                      + glob.glob(os.path.join(img_dir, '*.png')))
    streams.save_video_from_frames((read_image(p) for p in img_list),
                                   video_path, frame_rate)
