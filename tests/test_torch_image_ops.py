"""The port's undistortion and resizing (gsavatar_torch/data/image_ops.py)
against OpenCV, and its whole frame path `zju_format.load_image_mask`
against the JAX package's `load_image_mask(use_native=False)`, at the
published sizes (ZJU-MoCap 1024 -> 512, PeopleSnapshot 1080 -> 540) and at
the JAX loader tests' 1024 -> 64, with ZJU-like and PeopleSnapshot-like
intrinsics and distortion, on black and white backgrounds. Every path is
bit-equal: undistortion, the 2x area path, the generic fixed-point
bilinear path (1024 -> 64, 1024 -> 300), nearest and Lanczos4; the frames
as float32 after /255 are equal too. The float32 resize the serving apps
take (`cv2.resize` of a render and its alpha) is bit-equal to
`cv2.resize` on float32 with OpenCV's default (Intel IPP) path: 2x up, 2x
down, ratios that are not integers, odd sizes, upscales by 8-64x (the
CLIFF crops of the tooling), 1 and 3 channels, and values outside
[0, 1]."""
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


FLOAT_CASES = {'up2': (64, 64, 128, 128), 'down2': (128, 128, 64, 64),
               'odd_up': (37, 53, 100, 77), 'odd_down': (51, 33, 20, 17),
               'bench_up2': (540, 540, 1080, 1080), 'up_1_5': (64, 64, 96, 96),
               'same': (20, 30, 20, 30),
               # upscales by 8-64x: IPP's three-channel replicated-edge
               # columns, 5-15 a side after the runs of 16, and 16 or 32
               'up_12x': (20, 15, 256, 192), 'up_25x': (12, 9, 256, 192),
               'up_64x': (4, 3, 256, 192), 'up_edge_run': (50, 7, 98, 329)}


@pytest.mark.parametrize('channels', [0, 1, 3], ids=['hw', 'hw1', 'hw3'])
@pytest.mark.parametrize('case', sorted(FLOAT_CASES))
def test_float_resize_bit_equal(case, channels):
    H, W, h, w = FLOAT_CASES[case]
    rng = np.random.default_rng(H * W + channels)
    shape = (H, W) if channels == 0 else (H, W, channels)
    img = rng.random(shape, dtype=np.float32)
    want = cv2.resize(img, (w, h))
    got = image_ops.resize_linear(torch.from_numpy(img), (h, w))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_float_resize_wide_values_bit_equal():
    img = (np.random.default_rng(5).standard_normal((37, 41, 3))
           * 1000).astype(np.float32)
    np.testing.assert_array_equal(
        image_ops.resize_linear(torch.from_numpy(img), (70, 90)).numpy(),
        cv2.resize(img, (90, 70)))


def _round32(x):
    """The float32 nearest the Fraction x, ties to even."""
    from fractions import Fraction
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    best = min(abs(Fraction(float(g)) - x) for g in cands)
    near = [g for g in cands if abs(Fraction(float(g)) - x) == best]
    return min(near, key=lambda g: int(g.view(np.int32)) & 1)


def test_fma32_rounds_once():
    """`_fma32` against exact rational arithmetic: seeded values, and a sum
    just below a float32 tie whose float64 rounding lands on the tie (a
    float64 fma rounded again to float32 would round it up to even)."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    a = rng.standard_normal(2000).astype(np.float32)
    b = (rng.random(2000) * 2.0 ** -rng.integers(0, 30, 2000)).astype(
        np.float32)
    c = rng.standard_normal(2000).astype(np.float32)
    one = np.float32(1 + 2.0 ** -23)
    a = np.append(a, one)
    b = np.append(b, np.float32((1 - 2.0 ** -23) * 2.0 ** -24))
    c = np.append(c, one)
    got = image_ops._fma32(*(torch.from_numpy(x) for x in (a, b, c)))
    want = np.array([_round32(Fraction(float(x)) * Fraction(float(y))
                              + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[-1] == one
    naive = np.float32(np.float64(a[-1]) * np.float64(b[-1])
                       + np.float64(c[-1]))
    assert naive != one


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
