"""The port's host-side native code: a baseline JPEG decoder.

`jpeg.cc` is compiled at first use with `g++ -O3 -shared -fPIC -std=c++17`
into `build/jpeg-<hash of the source>.so` at the repository root and
loaded with ctypes; nothing is compiled when this module is imported. It
decodes what `cv2.imread` decodes for baseline files, to the same bits
(the source's header says how). A file the decoder cannot read, or a
failed build, raises: there is no other decoder behind it."""
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
