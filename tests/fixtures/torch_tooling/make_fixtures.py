"""Writes the SHA-256 digests that chip_smoke.py's phase 16 holds the
port's custom-video tooling to on the card, which has no OpenCV:

    python tests/fixtures/torch_tooling/make_fixtures.py

The seeded video and mask stack of `chip_smoke.tooling_frame` and
`tooling_masks` go through steps 2, 3, 5 and 6 of the JAX package's
`gsavatar.tooling.build_dataset` (OpenCV's video reader stood in for by
the seeded frames) and of the port's `gsavatar_torch.tooling.
build_dataset` on the CPU; the skeleton overlay and `process_image` of
the first frame through both packages. The two sets of digests
(`chip_smoke.tooling_digests`: JPEG bytes, PNG pixels, camera JSON, YOLO
texts and recovered masks, overlays) must be equal; they are written to
`digests.json`."""
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, '..', '..', '..'))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


class SeededCapture:
    """`cv2.VideoCapture`'s read interface over the seeded frames (BGR)."""

    def __init__(self, path):
        self.i = 0

    def read(self):
        if self.i >= cs.TOOL_FRAMES:
            return False, None
        self.i += 1
        return True, np.ascontiguousarray(cs.tooling_frame(self.i - 1)[..., ::-1])

    def release(self):
        pass


def jax_digests(root):
    """The digests of the JAX package's build on the seeded inputs."""
    import cv2
    from gsavatar.tooling import build_dataset as bd
    from gsavatar.tooling import cliff, skeleton
    subj = os.path.join(root, 'S1')
    masks_path = os.path.join(root, 'masks.npy')
    np.save(masks_path, cs.tooling_masks())
    capture = cv2.VideoCapture
    cv2.VideoCapture = SeededCapture
    try:
        bd.extract_images_and_masks(os.path.join(root, 'video.mp4'),
                                    masks_path, subj)
    finally:
        cv2.VideoCapture = capture
    bd.generate_camera_params(cs.TOOL_RAW[1], cs.TOOL_RAW[0],
                              os.path.join(subj, 'cam_params.json'))
    bd.build_yolo_seg_dataset(os.path.join(subj, '1'),
                              os.path.join(root, 'yolo'))
    os.makedirs(os.path.join(root, 'txt'))
    recovered = [bd.mask_to_yolo_txt(
        os.path.join(root, 'yolo', 'masks', f'{i:06d}.png'),
        os.path.join(root, 'txt', f'{i:06d}.txt'))
        for i in range(cs.TOOL_FRAMES)]
    rgb = cs.tooling_frame(0)
    over = skeleton.draw_skeleton(np.ascontiguousarray(rgb[..., ::-1]),
                                  cs.tooling_keypoints(), 3, 5)
    ys, xs = np.nonzero(cs.tooling_masks()[0])
    bbox = [2.0 * xs.min(), 2.0 * ys.min(), 2.0 * xs.max(), 2.0 * ys.max()]
    norm, _, _, _, _, crop = cliff.process_image(rgb, bbox)
    return cs.tooling_digests(root, recovered, {
        'skeleton overlay': over, 'process_image': norm,
        'process_image crop': crop})


def port_digests(root):
    """The digests of the port's build on the CPU."""
    recovered = cs.build_tooling_tree(root, 'cpu')
    return cs.tooling_digests(root, recovered, cs.tooling_overlays())


def main():
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        want, got = jax_digests(a), port_digests(b)
    bad = sorted(k for k in want if want[k] != got.get(k))
    if bad or set(want) != set(got):
        raise SystemExit(f"the port's tooling differs from the JAX "
                         f"package's: {bad}")
    with open(os.path.join(HERE, 'digests.json'), 'w') as f:
        json.dump(got, f, indent=1, sort_keys=True)
    print(f"{len(got)} digests written")


if __name__ == '__main__':
    main()
