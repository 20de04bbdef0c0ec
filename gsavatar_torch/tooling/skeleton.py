"""2D skeleton overlays for debugging pose streams.

Counterpart of `gsavatar/tooling/skeleton.py`: the 24-joint layout, the COCO
and MPII bone tables and their palette, verbatim. The bones and joints are
drawn by `utils/draw.py`, which gives `cv2.line`'s and `cv2.circle`'s
pixels."""
from __future__ import annotations

import numpy as np

from gsavatar_torch.utils import draw

# joint order: 0-5 legs R->L, 6-11 arms R->L, 12 neck, 13 head-top,
# 14 pelvis, 15 thorax, 16 spine, 17 jaw, 18 head, 19 nose, 20-23 eyes/ears
JOINT_NAMES = [
    'right_ankle', 'right_knee', 'right_hip', 'left_hip', 'left_knee',
    'left_ankle', 'right_wrist', 'right_elbow', 'right_shoulder',
    'left_shoulder', 'left_elbow', 'left_wrist', 'neck', 'head_top',
    'pelvis', 'thorax', 'spine', 'jaw', 'head', 'nose', 'left_eye',
    'right_eye', 'left_ear', 'right_ear']

# role colors, BGR
_TORSO = (0, 153, 255)
_LEFT = (255, 51, 255)
_RIGHT = (255, 178, 102)
_FACE = (0, 255, 0)

SKELETON_COCO = [
    ([9, 8], _TORSO), ([8, 2], _TORSO), ([2, 3], _TORSO), ([3, 9], _TORSO),
    ([9, 10], _LEFT), ([10, 11], _LEFT),
    ([8, 7], _RIGHT), ([7, 6], _RIGHT),
    ([2, 1], _RIGHT), ([1, 0], _RIGHT),
    ([3, 4], _LEFT), ([4, 5], _LEFT),
    ([23, 21], _FACE), ([21, 19], _FACE), ([19, 20], _FACE),
    ([20, 22], _FACE), ([20, 21], _FACE), ([9, 22], _FACE), ([8, 23], _FACE)]

SKELETON_MPII = [
    ([14, 15], _TORSO), ([15, 12], _TORSO), ([12, 13], _TORSO),
    ([15, 9], _LEFT), ([9, 10], _LEFT), ([10, 11], _LEFT),
    ([15, 8], _RIGHT), ([8, 7], _RIGHT), ([7, 6], _RIGHT),
    ([14, 2], _RIGHT), ([2, 1], _RIGHT), ([1, 0], _RIGHT),
    ([14, 3], _LEFT), ([3, 4], _LEFT), ([4, 5], _LEFT)]

_JOINT_COLORS = ([_RIGHT] * 3 + [_LEFT] * 3 + [_RIGHT] * 3 + [_LEFT] * 3
                 + [_TORSO] * 7 + [_FACE] * 5)


def draw_skeleton(img: np.ndarray, kp_24joints: np.ndarray,
                  line_width: int = 3, radius: int = 5) -> np.ndarray:
    """Draw a (24, 3) [x, y, conf] keypoint set onto a BGR uint8 image in
    place: the MPII bones when the head-top joint has confidence, the COCO
    bones otherwise; a bone or joint with conf <= 0 is skipped."""
    kp = np.asarray(kp_24joints)
    bones = SKELETON_MPII if kp[13, 2] > 0 else SKELETON_COCO
    for (parent, child), color in bones:
        if kp[parent, 2] * kp[child, 2] <= 0:
            continue
        draw.line(img, (int(kp[parent, 0]), int(kp[parent, 1])),
                  (int(kp[child, 0]), int(kp[child, 1])), color, line_width)
    for j, (px, py, conf) in enumerate(kp):
        if conf > 0:
            draw.circle(img, (int(px), int(py)), radius, _JOINT_COLORS[j])
    return img
