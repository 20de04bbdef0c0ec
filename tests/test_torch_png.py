"""The port's PNG reader and writer (gsavatar_torch/utils/png.py, stdlib
zlib and struct) against OpenCV and Pillow: a round trip; files written by
cv2 and by PIL decoded equal to `cv2.imread` in colour and in grey; the
port's frame PNG read back by cv2 equal to the frame. All comparisons are
exact."""
import cv2
import numpy as np
import pytest
import zlib
from PIL import Image

import torch_dist_workers  # noqa: F401  (torch on one thread)

from gsavatar_torch.utils import png

rng = np.random.default_rng(0)
RGB = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
GREY = (rng.random((37, 53)) * 255).astype(np.uint8)


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize('img', [RGB, GREY], ids=['rgb', 'grey'])
def test_round_trip(tmp_path, img):
    path = str(tmp_path / 'a.png')
    png.write_png(path, img)
    np.testing.assert_array_equal(png.decode_png(open(path, 'rb').read()),
                                  img)


def test_frame_png_read_by_cv2_and_pil(tmp_path):
    path = str(tmp_path / 'frame.png')
    png.write_png(path, RGB)
    np.testing.assert_array_equal(_cv2_rgb(path), RGB)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), RGB)


CV2_WRITTEN = {
    'grey': GREY, 'rgb': RGB[..., ::-1].copy(),
    'rgba': np.dstack([RGB[..., ::-1], GREY]),
}


@pytest.mark.parametrize('kind', sorted(CV2_WRITTEN))
def test_cv2_written_decodes_like_cv2(tmp_path, kind):
    path = str(tmp_path / f'{kind}.png')
    cv2.imwrite(path, CV2_WRITTEN[kind])
    np.testing.assert_array_equal(png.read_png(path, 'color'),
                                  _cv2_rgb(path))
    np.testing.assert_array_equal(png.read_png(path, 'gray'),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


PIL_MODES = ['L', 'LA', 'RGB', 'RGBA', 'P']


@pytest.mark.parametrize('mode', PIL_MODES)
def test_pil_written_decodes_like_cv2(tmp_path, mode):
    """Pillow filters rows adaptively (Average and Paeth included) and
    writes colour types 0, 4, 2, 6 and 3."""
    path = str(tmp_path / f'{mode}.png')
    src = Image.fromarray(np.dstack([RGB, GREY])).convert(mode)
    src.save(path)
    np.testing.assert_array_equal(png.read_png(path, 'color'),
                                  _cv2_rgb(path))
    np.testing.assert_array_equal(png.read_png(path, 'gray'),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize('writer', ['cv2_grey', 'cv2_rgb', 'pil_rgb'])
def test_mask_nonzero_like_cv2(tmp_path, writer):
    """Only `mask != 0` of a grey read matters to the loaders: masks
    written as grey and as RGB, with faint values that libpng's weights
    round to 0 (a pure-red 1 is 9797 / 2^15 -> 0)."""
    m = np.zeros((40, 40, 3), np.uint8)
    m[5:20, 5:20] = 255
    m[25:30, 25:30, 2] = 1        # red 1: grey 0
    m[30:35, 30:35, 1] = 2        # green 2: grey 1
    path = str(tmp_path / 'm.png')
    if writer == 'cv2_grey':
        cv2.imwrite(path, m[..., 0] | m[..., 1])
    elif writer == 'cv2_rgb':
        cv2.imwrite(path, m)
    else:
        Image.fromarray(m[..., ::-1]).save(path)
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE) != 0
    np.testing.assert_array_equal(png.read_png(path, 'gray') != 0, want)


def _with_ihdr(data: bytes, depth: int, interlace: int) -> bytes:
    ihdr = bytearray(data[16:29])
    ihdr[8], ihdr[12] = depth, interlace
    crc = zlib.crc32(b'IHDR' + bytes(ihdr)) & 0xFFFFFFFF
    return data[:16] + bytes(ihdr) + crc.to_bytes(4, 'big') + data[33:]


def test_sixteen_bit_and_interlaced_raise(tmp_path):
    path = str(tmp_path / 'deep.png')
    cv2.imwrite(path, (GREY.astype(np.uint16) * 257))
    with pytest.raises(ValueError, match='deep.png: 16-bit'):
        png.read_png(path)
    data = png.encode_png(GREY)
    with pytest.raises(ValueError, match='interlaced'):
        png.decode_png(_with_ihdr(data, 8, 1))
    with pytest.raises(ValueError, match='CRC'):
        png.decode_png(data[:20] + bytes([data[20] ^ 0xFF]) + data[21:])


def _unfilter_by_rows(data, h, stride, bpp):
    """PNG's five row filters undone one row at a time, as the format
    defines them: the reference for `png._unfilter`'s array form."""
    raw = np.frombuffer(data, np.uint8).reshape(h, stride + 1).astype(int)
    out = np.zeros((h, stride), int)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:]
        up = out[y - 1] if y else np.zeros(stride, int)
        for x in range(stride):
            a = out[y, x - bpp] if x >= bpp else 0
            c = up[x - bpp] if x >= bpp else 0
            b = up[x]
            if f == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) >> 1)[f]
            out[y, x] = (line[x] + pred) & 255
    return out.astype(np.uint8)


@pytest.mark.parametrize('bpp', [1, 3, 4])
def test_unfilter_matches_the_row_by_row_reference(bpp):
    """Seeded filter bytes: runs of each filter type, mixed rows, and
    images of one filter type only."""
    rng = np.random.default_rng(bpp)
    for t in range(40):
        h, w = int(rng.integers(1, 24)), int(rng.integers(1, 16))
        stride = w * bpp
        raw = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
        raw[:, 0] = (np.full(h, t % 5) if t < 5 else
                     np.repeat(rng.integers(0, 5, h // 3 + 1), 3)[:h])
        data = raw.tobytes()
        np.testing.assert_array_equal(png._unfilter(data, h, stride, bpp),
                                      _unfilter_by_rows(data, h, stride, bpp))
