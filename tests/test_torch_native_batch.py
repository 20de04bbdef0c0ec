"""The port's threaded frame preload (`gsavatar_torch.native.decode_batch`
and `Prefetcher`) against its one-frame path `zju_format.load_image_mask`
and the JAX package's Python frame path (`load_image_mask(use_native=
False)`, OpenCV), on JPEG/PNG frames written here by OpenCV with ZJU-like
distortion, both backgrounds, the linear and the Lanczos resize, one
camera for all frames and one per frame.

Tolerance: none. Every frame and mask equals the one-frame path's bit for
bit, on one thread and on several, in any schedule; so it equals the JAX
Python path's, and not the JAX native `decode_batch`'s, which rounds the
final /255 in float32 (one ulp off on some pixels, ROADMAP §3). The
interface is the JAX one: `n_threads`, `lookahead`, `set_schedule`,
`next` (None at the end, IOError on a file it cannot read) and `close`."""
import cv2
import numpy as np
import pytest
import torch

from torch_parity import smooth_frame

from gsavatar_torch import native
from gsavatar_torch.data import zju_format

from gsavatar.data.zju_format import load_image_mask as j_load_image_mask

RAW, OUT, N = 96, 48, 6
K = np.array([[110.0, 0, 48], [0, 112.0, 47], [0, 0, 1]], np.float32)
D = np.array([-0.2, 0.15, 1e-3, -8e-4, -0.03], np.float32)


@pytest.fixture(scope='module')
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp('frames')
    imgs, masks = [], []
    for i in range(N):
        img = smooth_frame(RAW, RAW, seed=i)
        m = np.zeros((RAW, RAW), np.uint8)
        cv2.ellipse(m, (RAW // 2 + i, RAW // 2), (RAW // 5, RAW // 3),
                    10 * i, 0, 360, 255, -1)
        imgs.append(str(d / f'{i:06d}.jpg'))
        masks.append(str(d / f'{i:06d}.png'))
        cv2.imwrite(imgs[-1], cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        cv2.imwrite(masks[-1], m)
    return imgs, masks


def _one_frame(imgs, masks, Ks, Ds, white, lanczos):
    return [zju_format.load_image_mask(i, m, k, dd, (OUT, OUT), white,
                                       lanczos)
            for i, m, k, dd in zip(imgs, masks, Ks, Ds)]


@pytest.mark.parametrize('lanczos', [False, True], ids=['linear', 'lanczos'])
@pytest.mark.parametrize('white', [False, True], ids=['black', 'white'])
def test_decode_batch_equals_one_frame_path(frames, white, lanczos):
    imgs, masks = frames
    want = _one_frame(imgs, masks, [K] * N, [D] * N, white, lanczos)
    for threads in (1, 3, 0):
        got_i, got_m = native.decode_batch(imgs, masks, K, D, (OUT, OUT),
                                           white, lanczos, n_threads=threads,
                                           device='cpu')
        assert got_i.shape == (N, OUT, OUT, 3) and got_m.shape == (N, OUT, OUT)
        assert got_i.dtype == got_m.dtype == torch.float32
        for j, (wi, wm) in enumerate(want):
            assert torch.equal(got_i[j], wi) and torch.equal(got_m[j], wm), j


def test_decode_batch_per_frame_cameras_match_jax(frames):
    """One K and distortion per frame; the frames equal the JAX Python
    path's."""
    imgs, masks = frames
    Ks = np.stack([K * np.float32(1 + 0.01 * i) for i in range(N)])
    Ks[:, 2, 2] = 1.0
    Ds = np.stack([D * np.float32(1 - 0.1 * i) for i in range(N)])
    got_i, got_m = native.decode_batch(imgs, masks, Ks, Ds, (OUT, OUT), False,
                                       n_threads=2, device='cpu')
    for j in range(N):
        wi, wm = j_load_image_mask(imgs[j], masks[j], Ks[j], Ds[j],
                                   (OUT, OUT), (RAW, RAW), False,
                                   use_native=False)
        np.testing.assert_array_equal(got_i[j].numpy(), wi)
        np.testing.assert_array_equal(got_m[j].numpy(), wm)


def test_decode_batch_raises_ioerror_on_a_bad_file(frames, tmp_path):
    imgs, masks = frames
    bad = tmp_path / 'bad.jpg'
    bad.write_bytes(b'\xff\xd8 not a jpeg')
    with pytest.raises(IOError, match='bad.jpg'):
        native.decode_batch(imgs[:2] + [str(bad)], masks[:3], K, D,
                            (OUT, OUT), False, n_threads=2, device='cpu')
    with pytest.raises(IOError, match='missing.png'):
        native.decode_batch(imgs[:1], [str(tmp_path / 'missing.png')], K, D,
                            (OUT, OUT), False, device='cpu')


@pytest.mark.parametrize('n_threads,lookahead', [(1, 1), (2, 4), (4, 2)])
def test_prefetcher_follows_its_schedules(frames, n_threads, lookahead):
    imgs, masks = frames
    want = _one_frame(imgs, masks, [K] * N, [D] * N, False, False)
    pf = native.Prefetcher(imgs, masks, K, D, (OUT, OUT), False,
                           lookahead=lookahead, n_threads=n_threads,
                           device='cpu')
    try:
        assert pf.next() is None                     # no schedule yet
        rng = np.random.default_rng(n_threads)
        for epoch in range(2):
            order = rng.permutation(N)
            pf.set_schedule(order)
            seen = []
            while (item := pf.next()) is not None:
                idx, img, mask = item
                seen.append(idx)
                assert torch.equal(img, want[idx][0])
                assert torch.equal(mask, want[idx][1])
            assert seen == order.tolist()
            assert pf.next() is None
        # a new schedule part-way through replaces the old one
        pf.set_schedule([5, 4, 3])
        assert pf.next()[0] == 5
        pf.set_schedule([0, 2, 2])
        assert [pf.next()[0] for _ in range(3)] == [0, 2, 2]
        assert pf.next() is None
    finally:
        pf.close()


def test_prefetcher_raises_ioerror_on_a_bad_file(frames, tmp_path):
    imgs, masks = frames
    bad = tmp_path / 'bad.png'
    bad.write_bytes(b'\x89PNG\r\n\x1a\n truncated')
    pf = native.Prefetcher(imgs[:2] + [imgs[2]], masks[:2] + [str(bad)], K, D,
                           (OUT, OUT), False, n_threads=2, device='cpu')
    try:
        pf.set_schedule([0, 2, 1])
        assert pf.next()[0] == 0
        with pytest.raises(IOError, match='bad.png'):
            pf.next()
    finally:
        pf.close()
