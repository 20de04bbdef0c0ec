"""Writes the frames that chip_smoke.py's phase 11 reads on the card, which
has no JPEG or PNG writer, and the SHA-256 digests it holds the port to:

    python tests/fixtures/torch_frames/make_fixtures.py

One 1024^2 frame (ZJU-MoCap's raw size) and one 1080^2 frame
(PeopleSnapshot's) of smooth seeded content, JPEG quality 90 at OpenCV's
default 4:2:0 sampling, each with a PNG mask. `digests.json` records, per
frame, the intrinsics and distortion the phase uses, the digest of
`cv2.imread`'s pixels (RGB), of the mask's grey read, and of the JAX
package's `zju_format.load_image_mask(use_native=False)` output (float32
frame, float32 mask) at the published output size on a black and a white
background."""
import hashlib
import json
import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.abspath(os.path.join(HERE, '..', '..', '..')))

from gsavatar.data.zju_format import load_image_mask  # noqa: E402

FRAMES = {
    'zju': {'raw': 1024, 'out': 512,
            'K': [[1100.0, 0.0, 512.0], [0.0, 1100.0, 512.0],
                  [0.0, 0.0, 1.0]],
            'D': [1e-3, 0.0, 0.0, 0.0, 0.0]},
    'ps': {'raw': 1080, 'out': 540,
           'K': [[1100.0, 0.0, 540.0], [0.0, 1090.0, 540.0],
                 [0.0, 0.0, 1.0]],
           'D': [-0.21, 0.17, 1.2e-3, -8e-4, -0.04]},
}


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def frame(n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    y, x = np.mgrid[0:n, 0:n] / n
    img = np.stack([128 + 100 * np.sin(6 * x + 3 * y + 1),
                    128 + 90 * np.cos(9 * y + 0.5),
                    128 + 60 * np.sin(5 * (x + y))], -1)
    img += rng.normal(0, 2, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def mask(n: int) -> np.ndarray:
    m = np.zeros((n, n), np.uint8)
    cv2.ellipse(m, (n // 2, n // 2), (n // 6, n * 2 // 5), 0, 0, 360, 255,
                -1)
    return m


def main():
    out = {}
    for name, spec in FRAMES.items():
        n = spec['raw']
        jpg, png = f'{name}_{n}.jpg', f'{name}_{n}.png'
        cv2.imwrite(os.path.join(HERE, jpg), frame(n),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        cv2.imwrite(os.path.join(HERE, png), mask(n))
        rec = dict(spec, jpeg=jpg, mask=png)
        rec['decoded_sha256'] = sha(cv2.cvtColor(
            cv2.imread(os.path.join(HERE, jpg)), cv2.COLOR_BGR2RGB))
        rec['mask_gray_sha256'] = sha(cv2.imread(os.path.join(HERE, png),
                                                 cv2.IMREAD_GRAYSCALE))
        for bg, white in (('black', False), ('white', True)):
            img, msk = load_image_mask(
                os.path.join(HERE, jpg), os.path.join(HERE, png),
                np.array(spec['K'], np.float32),
                np.array(spec['D'], np.float32), (spec['out'],) * 2,
                (n, n), white, use_native=False)
            rec[bg] = {'image_sha256': sha(img), 'mask_sha256': sha(msk)}
        out[name] = rec
    with open(os.path.join(HERE, 'digests.json'), 'w') as f:
        json.dump(out, f, indent=1)


if __name__ == '__main__':
    main()
