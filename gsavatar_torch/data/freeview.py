"""Freeview orbit cameras.

The port's own copy of `gsavatar/data/freeview.py`: the first camera's
extrinsics rotated about an axis through the subject's centre, in
total_frames + 1 steps of a full turn."""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def _update_extrinsics(extrinsics, angle, trans=None, rotate_axis='y'):
    E = extrinsics
    inv_E = np.linalg.inv(E)
    camrot = inv_E[:3, :3]
    campos = inv_E[:3, 3]
    if trans is not None:
        campos = campos - trans

    if camrot.T[1, 1] < 0.0:
        angle = -angle

    axis_i = {'x': 0, 'y': 1, 'z': 2}[rotate_axis]
    grot_vec = np.zeros(3)
    grot_vec[axis_i] = angle
    grot_mtx = Rotation.from_rotvec(grot_vec).as_matrix().astype(np.float32)

    rot_campos = grot_mtx @ campos
    rot_camrot = grot_mtx @ camrot
    if trans is not None:
        rot_campos = rot_campos + trans

    new_E = np.identity(4)
    new_E[:3, :3] = rot_camrot.T
    new_E[:3, 3] = -rot_camrot.T @ rot_campos
    return new_E


def freeview_camera(camera: dict, trans, total_frames: int = 100,
                    rotate_axis: str = 'z', inv_angle: bool = False) -> dict:
    cam_names = [str(i) for i in range(total_frames + 1)]
    all_cam_params = {'all_cam_names': cam_names}
    for frame_idx, cam_name in enumerate(cam_names):
        Ri = np.array(camera['R'], np.float32)
        Ti = np.array(camera['T'], np.float32).reshape(3, 1)
        Ei = np.eye(4)
        Ei[:3, :3] = Ri
        Ei[:3, 3:] = Ti
        angle = 2 * np.pi * (frame_idx / total_frames)
        if inv_angle:
            angle = -angle
        Eo = _update_extrinsics(Ei, angle, np.asarray(trans), rotate_axis)
        all_cam_params[cam_name] = {
            'K': camera['K'], 'D': camera['D'],
            'R': Eo[:3, :3], 'T': Eo[:3, 3:],
        }
    return all_cam_params
