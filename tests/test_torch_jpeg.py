"""The port's JPEG decoder (gsavatar_torch/native, built here with g++)
against `cv2.imread` on files that `cv2.imwrite` wrote: every case must be
bit-equal to `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`. Files
the decoder does not read (progressive, arithmetic-coded) raise with their
name."""
import cv2
import numpy as np
import pytest

from torch_parity import smooth_frame

from gsavatar_torch import native

SAMPLING = {'420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def _check(tmp_path, img, params):
    path = str(tmp_path / 'f.jpg')
    assert cv2.imwrite(path, img, params)
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    got = native.read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('quality', [75, 95])
@pytest.mark.parametrize('sampling', sorted(SAMPLING))
def test_sampling_and_quality_bit_equal(tmp_path, quality, sampling):
    """An odd size (not a multiple of any MCU) at each sampling."""
    _check(tmp_path, smooth_frame(101, 67, quality),
           [cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])


@pytest.mark.parametrize('sampling', ['420', '422'])
def test_restart_interval_bit_equal(tmp_path, sampling):
    _check(tmp_path, smooth_frame(96, 130, 7),
           [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])


def test_grey_jpeg_bit_equal(tmp_path):
    _check(tmp_path, smooth_frame(77, 99, 3, grey=True),
           [cv2.IMWRITE_JPEG_QUALITY, 90])


@pytest.mark.parametrize('size', [1080, 1024])
def test_full_size_frames_bit_equal(tmp_path, size):
    """The published sizes (PeopleSnapshot 1080^2, ZJU-MoCap 1024^2) at
    OpenCV's default quality and sampling."""
    _check(tmp_path, smooth_frame(size, size, size), [])


def test_noise_frame_bit_equal(tmp_path):
    """Uniform noise: every coefficient in use, the range limit hit."""
    rng = np.random.default_rng(0)
    _check(tmp_path, (rng.random((64, 80, 3)) * 255).astype(np.uint8), [])


def test_progressive_raises_with_the_name(tmp_path):
    path = str(tmp_path / 'prog.jpg')
    cv2.imwrite(path, smooth_frame(64, 64, 1),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match='prog.jpg: progressive'):
        native.read_jpeg(path)


def test_arithmetic_and_garbage_raise():
    # a frame header of an arithmetic-coded file (SOF9)
    sof9 = (b'\xff\xd8\xff\xc9\x00\x0b\x08\x00\x10\x00\x10\x01\x01\x11\x00'
            b'\xff\xd9')
    with pytest.raises(ValueError, match='x.jpg: arithmetic'):
        native.decode_jpeg(sof9, 'x.jpg')
    with pytest.raises(ValueError, match='not a JPEG'):
        native.decode_jpeg(b'\x89PNG\r\n\x1a\n', 'y.jpg')


def test_library_is_named_by_its_source(tmp_path, monkeypatch):
    src = tmp_path / 'jpeg.cc'
    src.write_text(native.SRC.read_text())
    monkeypatch.setattr(native, 'SRC', src)
    before = native._target()
    src.write_text(src.read_text() + '\n// edited\n')
    assert native._target() != before
    assert before.name.startswith('jpeg-') and before.suffix == '.so'
