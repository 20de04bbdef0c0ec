"""The port's host-side native code: a baseline JPEG decoder and encoder,
and the threaded frame preload (`decode_batch`, `Prefetcher`).

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
import torch

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


def _per_frame(a, size: int, n: int) -> np.ndarray:
    """One row of `size` per frame: `a` shared by all frames or given per
    frame."""
    a = np.asarray(a, np.float64)
    if a.size == size:
        return np.broadcast_to(a.reshape(size), (n, size))
    return a.reshape(n, size)


def _read_pair(img_path: str, mask_path: str):
    """The frame and mask as decoded uint8 arrays; any failure as an
    IOError naming the files."""
    from gsavatar_torch.data.zju_format import read_image_mask
    try:
        return read_image_mask(img_path, mask_path)
    except Exception as e:     # a truncated file fails in zlib or struct
        raise IOError(f"{img_path}, {mask_path}: {e!r}") from e


def decode_batch(img_paths, mask_paths, K, dist, hw_out, white_bg: bool,
                 lanczos: bool = False, n_threads: int = 0, device=None):
    """Preload: `zju_format.load_image_mask` of every (frame, mask) pair,
    as (n, h, w, 3) frames and (n, h, w) masks, float32 tensors on
    `device`. The files are decoded on `n_threads` host threads (0: one
    per CPU; the decoders release the GIL), each pair undistorted and
    resized on the device as it arrives, in order. `K` and `dist` are one
    camera's (9 and 5 values) or one per frame. A file that cannot be
    read raises an IOError."""
    from concurrent.futures import ThreadPoolExecutor
    from gsavatar_torch.data.zju_format import transform_image_mask
    from gsavatar_torch.device import resolve_device
    device = resolve_device(device)
    n = len(img_paths)
    h, w = hw_out
    Ks, ds = _per_frame(K, 9, n), _per_frame(dist, 5, n)
    imgs = torch.empty((n, h, w, 3), dtype=torch.float32, device=device)
    masks = torch.empty((n, h, w), dtype=torch.float32, device=device)
    n_threads = n_threads if n_threads > 0 else (os.cpu_count() or 1)
    with ThreadPoolExecutor(max(1, min(n_threads, n))) as pool:
        pairs = pool.map(_read_pair, img_paths, mask_paths)
        for i, (img, mask) in enumerate(pairs):
            imgs[i], masks[i] = transform_image_mask(
                torch.as_tensor(img, device=device),
                torch.as_tensor(mask, device=device), Ks[i].reshape(3, 3),
                ds[i], hw_out, white_bg, lanczos)
    return imgs, masks


class Prefetcher:
    """A lookahead decoder driven by an epoch schedule:

        pf = Prefetcher(img_paths, mask_paths, K, dist, (h, w), white_bg)
        pf.set_schedule(permutation)      # per epoch
        idx, img, mask = pf.next()        # blocks until decoded
        pf.close()

    `n_threads` host threads decode the files of the next `lookahead`
    scheduled items; `next` undistorts and resizes the item on `device`
    in the caller's thread and returns (its dataset index, the frame
    (h, w, 3), the mask (h, w)), the values of
    `zju_format.load_image_mask`; None once the schedule is done. A file
    that cannot be read raises an IOError from `next`. A new schedule
    drops what was decoded for the old one and not taken."""

    def __init__(self, img_paths, mask_paths, K, dist, hw_out, white_bg,
                 lanczos=False, lookahead=4, n_threads=2, device=None):
        import threading
        from gsavatar_torch.device import resolve_device
        self.device = resolve_device(device)
        n = len(img_paths)
        self._paths = list(zip(img_paths, mask_paths))
        self._Ks, self._ds = _per_frame(K, 9, n), _per_frame(dist, 5, n)
        self._args = (tuple(hw_out), bool(white_bg), bool(lanczos))
        self._lookahead = lookahead if lookahead > 0 else 4
        self._cv = threading.Condition()
        self._schedule: list = []
        self._cursor = self._next = self._gen = 0
        self._ready: dict = {}
        self._error = None
        self._stop = False
        self._workers = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(n_threads if n_threads > 0 else 2)]
        for t in self._workers:
            t.start()

    def _work(self):
        while True:
            with self._cv:
                while not self._stop and not (
                        self._next < len(self._schedule)
                        and self._next - self._cursor < self._lookahead):
                    self._cv.wait()
                if self._stop:
                    return
                pos, gen = self._next, self._gen
                item = self._schedule[pos]
                self._next += 1
            try:
                got, err = _read_pair(*self._paths[item]), None
            except IOError as e:
                got, err = None, str(e)
            with self._cv:
                if gen == self._gen:
                    if err is not None:
                        self._error = self._error or err
                    else:
                        self._ready[pos] = got
                    self._cv.notify_all()

    def set_schedule(self, order):
        with self._cv:
            self._schedule = [int(i) for i in order]
            self._cursor = self._next = 0
            self._gen += 1
            self._ready.clear()
            self._cv.notify_all()

    def next(self):
        with self._cv:
            if self._cursor >= len(self._schedule):
                return None
            pos = self._cursor
            while pos not in self._ready and self._error is None:
                self._cv.wait()
            if pos not in self._ready:
                raise IOError(self._error)
            img, mask = self._ready.pop(pos)
            item = self._schedule[pos]
            self._cursor += 1
            self._cv.notify_all()
        from gsavatar_torch.data.zju_format import transform_image_mask
        hw_out, white_bg, lanczos = self._args
        frame, m = transform_image_mask(
            torch.as_tensor(img, device=self.device),
            torch.as_tensor(mask, device=self.device),
            self._Ks[item].reshape(3, 3), self._ds[item], hw_out, white_bg,
            lanczos)
        return item, frame, m

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._workers:
            t.join()
        self._workers = []

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
