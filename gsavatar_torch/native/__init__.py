"""The port's host-side native code: a baseline JPEG decoder and encoder.

`jpeg.cc` is compiled at first use with `g++ -O3 -shared -fPIC -std=c++17`
into `build/jpeg-<hash of the source>.so` at the repository root and
loaded with ctypes; nothing is compiled when this module is imported. It
decodes what `cv2.imread` decodes for baseline files, to the same bits
(the source's header says how), and encodes what `cv2.imencode('.jpg')`
writes at its defaults (quality 95, 4:2:0), to the same bytes. A file the
decoder cannot read, or a failed build, raises: there is no other codec
behind it."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / 'jpeg.cc'
BUILD = Path(__file__).resolve().parents[2] / 'build'
CXX_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']

_lib = None


def _target() -> Path:
    h = hashlib.sha1(SRC.read_bytes()).hexdigest()[:12]
    return BUILD / f'jpeg-{h}.so'


def build() -> Path:
    """The decoder's library, compiled if it is not there yet."""
    target = _target()
    if target.exists():
        return target
    cxx = shutil.which('g++')
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) found to build the JPEG "
                           "decoder")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.run([cxx, *CXX_FLAGS, '-o', str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the JPEG decoder failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ip = ctypes.POINTER(ctypes.c_int)
        lib.gsj_info.restype = ctypes.c_int
        lib.gsj_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ip, ip,
                                 ip, ctypes.c_char_p, ctypes.c_int]
        lib.gsj_decode.restype = ctypes.c_int
        lib.gsj_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_int]
        lib.gsj_encode.restype = ctypes.c_long
        lib.gsj_encode.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


def decode_jpeg(data: bytes, name: str = '<bytes>') -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG file's bytes; a grey file comes back
    with its value in all three channels. Raises ValueError, naming
    `name`, on a file the decoder does not read."""
    lib = _load()
    err = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.gsj_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                    ctypes.byref(c), err, len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.gsj_decode(data, len(data), out.ctypes.data, w.value, h.value,
                      err, len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    with open(path, 'rb') as f:
        return decode_jpeg(f.read(), str(path))


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """The JPEG file of an (H, W, 3) uint8 RGB image: baseline, 4:2:0, the
    bytes `cv2.imencode('.jpg', bgr, [IMWRITE_JPEG_QUALITY, quality])`
    gives for its BGR twin."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8 RGB, got "
                         f"{rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    # at most 27 bits per coefficient, each byte possibly stuffed
    mcus = ((h + 15) // 16) * ((w + 15) // 16)
    out = np.empty(1024 + mcus * 6 * 64 * 8, np.uint8)
    err = ctypes.create_string_buffer(256)
    n = _load().gsj_encode(rgb.ctypes.data, w, h, int(quality),
                           out.ctypes.data, out.nbytes, err, len(err))
    if n < 0:
        raise ValueError(f"encode_jpeg: {err.value.decode()}")
    return out[:n].tobytes()


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """`encode_jpeg` into the file `path`."""
    data = encode_jpeg(rgb, quality)
    with open(path, 'wb') as f:
        f.write(data)
