"""The port's undistortion and resizing (gsavatar_torch/data/image_ops.py)
against OpenCV, and its whole frame path `zju_format.load_image_mask`
against the JAX package's `load_image_mask(use_native=False)`, at the
published sizes (ZJU-MoCap 1024 -> 512, PeopleSnapshot 1080 -> 540) and at
the JAX loader tests' 1024 -> 64, with ZJU-like and PeopleSnapshot-like
intrinsics and distortion, on black and white backgrounds. Every path is
bit-equal: undistortion, the 2x area path, the generic fixed-point
bilinear path (1024 -> 64, 1024 -> 300), nearest and Lanczos4; the frames
as float32 after /255 are equal too."""
import cv2
import numpy as np
import pytest
import torch

from torch_parity import smooth_frame

from gsavatar_torch.data import image_ops, zju_format

from gsavatar.data.zju_format import load_image_mask as j_load_image_mask

ZJU_K = np.array([[1100, 0, 512], [0, 1100, 512], [0, 0, 1]], np.float32)
ZJU_D = np.array([1e-3, 0, 0, 0, 0], np.float32)
PS_K = np.array([[1296.7, 0, 540], [0, 1296.8, 540], [0, 0, 1]], np.float32)
PS_D = np.array([-0.21, 0.17, 1.2e-3, -8e-4, -0.04], np.float32)
CASES = {'zju_512': (1024, 512, ZJU_K, ZJU_D),
         'zju_64': (1024, 64, ZJU_K, ZJU_D),
         'ps_540': (1080, 540, PS_K, PS_D)}


def _mask(raw):
    m = np.zeros((raw, raw), np.uint8)
    cv2.ellipse(m, (raw // 2, raw // 2), (raw // 5, raw // 3), 20, 0, 360,
                255, -1)
    return m


def _undistort(img, K, D):
    fixed = image_ops.undistort_map(K, D, img.shape[0], img.shape[1], 'cpu')
    return image_ops.remap_linear(torch.from_numpy(img), fixed).numpy()


@pytest.mark.parametrize('case', sorted(CASES))
def test_undistort_bit_equal(case):
    raw, _, K, D = CASES[case]
    img = smooth_frame(raw, raw, raw)
    np.testing.assert_array_equal(_undistort(img, K, D),
                                  cv2.undistort(img, K, D))
    m = _mask(raw)
    np.testing.assert_array_equal(_undistort(m, K, D), cv2.undistort(m, K, D))


def test_undistort_map_is_built_once_per_view():
    """The kept map is the built one, and one view's frames share it."""
    raw = 256
    kept = image_ops.undistort_map(PS_K, PS_D, raw, raw, 'cpu')
    assert image_ops.undistort_map(PS_K.copy(), PS_D.copy(), raw, raw,
                                   torch.device('cpu')) is kept
    assert torch.equal(kept, image_ops.build_undistort_map(PS_K, PS_D, raw,
                                                           raw, 'cpu'))
    other = image_ops.undistort_map(PS_K, ZJU_D, raw, raw, 'cpu')
    assert other is not kept and not torch.equal(other, kept)


@pytest.mark.parametrize('raw,out', [(1024, 512), (1080, 540), (1024, 64),
                                     (1024, 300), (64, 64)])
def test_resize_bit_equal(raw, out):
    img = smooth_frame(raw, raw, out)
    t = torch.from_numpy(img)
    for fn, flag in ((image_ops.resize_linear, cv2.INTER_LINEAR),
                     (image_ops.resize_nearest, cv2.INTER_NEAREST),
                     (image_ops.resize_lanczos4, cv2.INTER_LANCZOS4)):
        np.testing.assert_array_equal(
            fn(t, (out, out)).numpy(),
            cv2.resize(img, (out, out), interpolation=flag), fn.__name__)


@pytest.mark.parametrize('white', [False, True], ids=['black', 'white'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_load_image_mask_matches_jax(tmp_path, case, white):
    raw, out, K, D = CASES[case]
    img_file, mask_file = str(tmp_path / 'f.jpg'), str(tmp_path / 'f.png')
    cv2.imwrite(img_file, smooth_frame(raw, raw, out))
    cv2.imwrite(mask_file, _mask(raw))
    want_img, want_mask = j_load_image_mask(
        img_file, mask_file, K, D, (out, out), (raw, raw), white,
        use_native=False)
    got_img, got_mask = zju_format.load_image_mask(
        img_file, mask_file, K, D, (out, out), white)
    assert got_img.dtype == torch.float32 and got_mask.dtype == torch.float32
    np.testing.assert_array_equal(got_img.numpy(), want_img)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    assert 0.0 < float(got_mask.mean()) < 1.0


def test_load_image_mask_lanczos_matches_jax(tmp_path):
    img_file, mask_file = str(tmp_path / 'f.jpg'), str(tmp_path / 'f.png')
    cv2.imwrite(img_file, smooth_frame(1024, 1024, 5))
    cv2.imwrite(mask_file, _mask(1024))
    want = j_load_image_mask(img_file, mask_file, ZJU_K, ZJU_D, (300, 300),
                             (1024, 1024), False, lanczos=True,
                             use_native=False)
    got = zju_format.load_image_mask(img_file, mask_file, ZJU_K, ZJU_D,
                                     (300, 300), False, lanczos=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_chip_smoke_fixture_digests():
    """The committed frames that chip_smoke.py's phase 11 holds the port
    to on the card: the port equals their digests here too (they were made
    from OpenCV's decode and the JAX frame path, which
    test_load_image_mask_matches_jax holds the port to)."""
    import json
    import os
    import chip_smoke
    with open(os.path.join(chip_smoke.FIXTURES, 'digests.json')) as f:
        spec = json.load(f)
    checks = chip_smoke.frame_digests('cpu')
    assert len(checks) == 6 * len(spec) == 12
    for label, want, got in checks:
        assert got == want, label
    for rec in spec.values():
        jpg = os.path.join(chip_smoke.FIXTURES, rec['jpeg'])
        assert chip_smoke._sha(cv2.cvtColor(cv2.imread(jpg),
                                            cv2.COLOR_BGR2RGB)) \
            == rec['decoded_sha256']
