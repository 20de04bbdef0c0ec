"""The port's JPEG decoder (gsavatar_torch/native, built here with g++)
against `cv2.imread` on files that `cv2.imwrite` wrote: every case must be
bit-equal to `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`. Files
the decoder does not read (progressive, arithmetic-coded) raise with their
name. The port's encoder against `cv2.imencode('.jpg')` at its defaults
(quality 95, 4:2:0): the same bytes, on seeded images of sizes that are
and are not multiples of the MCU."""
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


ENCODE_CASES = {
    '37x53_smooth': lambda: smooth_frame(37, 53, 1),
    '64x64_smooth': lambda: smooth_frame(64, 64, 2),
    '512x512_smooth': lambda: smooth_frame(512, 512, 3),
    '37x53_noise': lambda: (np.random.default_rng(4).random((37, 53, 3))
                            * 255).astype(np.uint8),
    '64x64_flat': lambda: np.full((64, 64, 3), (200, 30, 90), np.uint8),
    '1x1': lambda: smooth_frame(1, 1, 5),
    '17x9_smooth': lambda: smooth_frame(17, 9, 6),
}


@pytest.mark.parametrize('case', sorted(ENCODE_CASES))
def test_encoder_bytes_equal_cv2(case, tmp_path):
    """The bytes cv2 writes for the image's BGR twin; the file decodes,
    through the port's decoder, to what cv2 decodes."""
    img = ENCODE_CASES[case]()
    ok, want = cv2.imencode('.jpg', cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    got = native.encode_jpeg(img)
    assert got == want.tobytes()
    path = tmp_path / 'f.jpg'
    native.write_jpeg(str(path), img)
    assert path.read_bytes() == got
    np.testing.assert_array_equal(
        native.read_jpeg(str(path)),
        cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB))


@pytest.mark.parametrize('quality', [50, 75, 100])
def test_encoder_quality_bytes_equal_cv2(quality):
    img = smooth_frame(40, 72, quality)
    ok, want = cv2.imencode('.jpg', cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                            [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert native.encode_jpeg(img, quality) == want.tobytes()


def test_encoder_refuses_what_it_does_not_write():
    with pytest.raises(ValueError, match='uint8 RGB'):
        native.encode_jpeg(np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match='uint8 RGB'):
        native.encode_jpeg(np.zeros((8, 8, 3), np.float32))
