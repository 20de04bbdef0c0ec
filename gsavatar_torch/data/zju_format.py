"""What the ZJU-format loaders share (ZJU-MoCap, custom videos,
PeopleSnapshot): reading a frame and its mask, undistorting and resizing
them, the principal-point recentering, the K rescale and the assembly of a
camera record from an SMPL npz.

The port's own copy of `gsavatar/data/zju_format.py`. The JAX package
reads and transforms frames with OpenCV; the port decodes JPEG with its
own decoder (`gsavatar_torch/native`), PNG with `utils/png.py`, and
undistorts and resizes with `data/image_ops.py` on the camera's device,
to the same integers."""
from __future__ import annotations

import numpy as np
import torch

from gsavatar_torch import native
from gsavatar_torch.camera import graphics
from gsavatar_torch.camera.camera import Camera, make_camera
from gsavatar_torch.utils import png
from . import base, image_ops

_BY_255 = (np.arange(256) / 255.0).astype(np.float32)


def read_image(path: str, mode: str = 'color') -> np.ndarray:
    """A JPEG or PNG file as (H, W, 3) uint8 RGB ('color') or (H, W) grey
    ('gray', PNG only), as `cv2.imread` reads it."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:2] == b'\xff\xd8':
        if mode != 'color':
            raise ValueError(f"{path}: a JPEG is read in colour only")
        return native.decode_jpeg(data, str(path))
    if data[:8] == b'\x89PNG\r\n\x1a\n':
        return png.as_mode(png.decode_png(data, str(path)), mode)
    raise ValueError(f"{path}: neither a JPEG nor a PNG file")


def read_image_mask(img_file: str, mask_file: str):
    """The frame (H, W, 3) and its mask (H, W) as decoded uint8 arrays:
    the host's part of `load_image_mask`."""
    image = read_image(img_file, 'color')
    mask = read_image(mask_file, 'gray')
    if mask.shape != image.shape[:2]:
        raise ValueError(f"{mask_file}: mask {tuple(mask.shape)} and frame "
                         f"{tuple(image.shape[:2])} differ in size")
    return image, mask


def transform_image_mask(image: torch.Tensor, mask: torch.Tensor, K, dist,
                         hw_out, white_bg: bool, lanczos: bool = False):
    """The device's part of `load_image_mask`, on the decoded uint8 frame
    and mask and on their device: undistort both, resize them (linear or
    Lanczos for the frame, nearest for the mask), set the frame to 0 or
    255 outside the mask and scale it to [0, 1]. Returns the frame
    (h, w, 3) and the mask (h, w) as float32."""
    # one map for the frame and its mask
    fixed = image_ops.undistort_map(K, dist, image.shape[0], image.shape[1],
                                    image.device)
    image = image_ops.remap_linear(image, fixed)
    mask = image_ops.remap_linear(mask, fixed)
    resize = image_ops.resize_lanczos4 if lanczos \
        else image_ops.resize_linear
    image = resize(image, hw_out)
    mask = image_ops.resize_nearest(mask, hw_out) != 0
    image = torch.where(mask[..., None], image,
                        torch.full_like(image, 255 if white_bg else 0))
    # numpy's (image / 255.0).astype(float32), by table: torch may divide
    # by a scalar as a multiply by its reciprocal, which rounds otherwise
    image = torch.as_tensor(_BY_255, device=image.device)[image.long()]
    return image, mask.to(torch.float32)


def load_image_mask(img_file: str, mask_file: str, K, dist, hw_out,
                    white_bg: bool, lanczos: bool = False, device='cpu'):
    """`read_image_mask` on the host, then `transform_image_mask` on
    `device`: the frame (h, w, 3) and mask (h, w) as float32 tensors."""
    image, mask = read_image_mask(img_file, mask_file)
    return transform_image_mask(torch.as_tensor(image, device=device),
                                torch.as_tensor(mask, device=device),
                                K, dist, hw_out, white_bg, lanczos)


def recenter_extrinsics(K, R, T, W: int, H: int):
    """Fold the principal point's offset from the image centre into the
    extrinsics; returns (K with a centred principal point, R, T)."""
    K = K.copy()
    M = np.eye(3)
    M[0, 2] = (K[0, 2] - W / 2) / K[0, 0]
    M[1, 2] = (K[1, 2] - H / 2) / K[1, 1]
    K[0, 2] = W / 2
    K[1, 2] = H / 2
    R = M @ R
    T = M @ T
    return K, R, T


def build_camera(*, K, dist, R, T, img_file, mask_file, model_dict,
                 metadata, hw_out, hw_raw, white_bg, lanczos, frame_idx,
                 cam_name, frame_dict, device='cpu',
                 frames: bool = True) -> Camera:
    """One camera record with its frame and mask on `device` (without
    `frames`, with neither, and no image file is read)."""
    W_raw, H_raw = hw_raw[1], hw_raw[0]
    K, R, T = recenter_extrinsics(K, R, T, W_raw, H_raw)
    R = np.transpose(R)
    T = T[:, 0] if T.ndim == 2 else T

    image, mask = (load_image_mask(img_file, mask_file, K, dist, hw_out,
                                   white_bg, lanczos, device=device)
                   if frames else (None, None))
    h, w = hw_out
    K = K.copy()
    K[0, :] *= w / W_raw
    K[1, :] *= h / H_raw
    fovx = graphics.focal_to_fov(K[0, 0], w)
    fovy = graphics.focal_to_fov(K[1, 1], h)

    trans = model_dict['trans'].astype(np.float32)
    bone_transforms = model_dict['bone_transforms'].astype(np.float32)
    rots = base.pose_to_rots(model_dict['root_orient'].astype(np.float32),
                             model_dict['pose_body'].astype(np.float32),
                             model_dict['pose_hand'].astype(np.float32))
    Jtr_norm = base.normalize_Jtr(metadata['Jtr'], metadata['minimal_shape'])
    bt = base.compose_bone_transforms(
        bone_transforms, metadata['bone_transforms_02v'], trans)

    in_dict = frame_idx in (frame_dict or {})
    li = (frame_dict or {}).get(frame_idx, max(len(frame_dict or {}) - 1, 0))
    fname = frame_idx if frame_idx >= 0 else -frame_idx - 1
    cam = make_camera(
        R=R, T=T, fovx=fovx, fovy=fovy, width=w, height=h, rots=rots[None],
        Jtrs=Jtr_norm[None], bone_transforms=bt, frame_id=frame_idx,
        cam_id=int(cam_name), image_name=f"c{int(cam_name):02d}_f{fname:06d}",
        latent_idx=li, pose_idx=li, in_frame_dict=float(in_dict),
        device=device)
    return cam.replace(image=image, mask=mask)


def load_pose_ground_truth(frames, model_files):
    """The SMPL parameters of the selected frames, stacked for the pose
    correction: betas of the first frame, then per frame root_orient,
    pose_body, pose_hand and trans."""
    ret = {'frames': list(frames), 'root_orient': [], 'pose_body': [],
           'pose_hand': [], 'trans': []}
    for idx, model_file in enumerate(model_files):
        md = np.load(model_file)
        if idx == 0:
            ret['betas'] = md['betas'].astype(np.float32)
        ret['root_orient'].append(md['root_orient'].astype(np.float32))
        ret['pose_body'].append(md['pose_body'].astype(np.float32))
        ret['pose_hand'].append(md['pose_hand'].astype(np.float32))
        ret['trans'].append(md['trans'].astype(np.float32))
    return ret
