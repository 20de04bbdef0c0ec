"""PNG files with the standard library: `zlib`, `struct` and numpy.

Encoding writes 8-bit grey or RGB with filter 0 on every row. Decoding
reads 8-bit, non-interlaced files of colour types 0 (grey), 2 (RGB), 3
(palette), 4 (grey and alpha) and 6 (RGBA) with any of the five row
filters; 16-bit, sub-byte and interlaced files raise. `read_png(path,
'gray')` gives what `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` gives: the
alpha channel dropped, and colour through libpng's truncating
`png_do_rgb_to_gray` with its 15-bit weights (9797, 19234, 3737) for R, G
and B. `read_png(path, 'color')` gives RGB (grey repeated in the three
channels), as `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)` does.

Rows filtered with None or Sub are undone all at once, and each run of Up
rows as one running sum down the columns (array operations that release
the GIL on large images); Average and Paeth, which depend on the pixel
to the left, take a Python loop over the row's pixels and are slow on
large images."""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# libpng's png_set_rgb_to_gray(0.299, 0.587) coefficients, scaled by 2^15
GRAY_WEIGHTS = (9797, 19234, 3737)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """The PNG bytes of an 8-bit (H, W) grey or (H, W, 3) RGB image."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3), not "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)
    ihdr = struct.pack('>IIBBBBB', w, h, 8, color_type, 0, 0, 0)
    return (_SIGNATURE + _chunk(b'IHDR', ihdr)
            + _chunk(b'IDAT', zlib.compress(rows.tobytes(), level))
            + _chunk(b'IEND', b''))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, 'wb') as f:
        f.write(encode_png(img))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    raw = np.frombuffer(data, np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("truncated image data")
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    filt, lines = raw[:, 0], raw[:, 1:]
    bad = filt[filt > 4]
    if bad.size:
        raise ValueError(f"bad PNG filter type {bad[0]}")
    out = np.empty((h, stride), np.uint8)
    # None and Sub rows need no other row: all of them at once
    none, sub = filt == 0, filt == 1
    out[none] = lines[none]
    n = int(sub.sum())
    if n:
        out[sub] = np.cumsum(lines[sub].reshape(n, -1, bpp), axis=1,
                             dtype=np.uint8).reshape(n, stride)
    # the rows that add the row above, in order: a run of Up rows is a
    # running sum down the columns, mod 256
    y = 0
    zero = np.zeros(stride, np.uint8)
    while y < h:
        f = filt[y]
        if f < 2:
            y += 1
            continue
        prior = out[y - 1] if y else zero
        if f == 2:
            end = y + 1
            while end < h and filt[end] == 2:
                end += 1
            out[y:end] = np.cumsum(lines[y:end], axis=0, dtype=np.uint8) \
                + prior
            y = end
            continue
        row = lines[y].astype(np.int32)
        up = prior.astype(np.int32)
        for x in range(0, stride, bpp):
            left = row[x - bpp:x] if x else np.zeros(bpp, np.int32)
            b = up[x:x + bpp]
            if f == 3:
                pred = (left + b) >> 1
            else:
                ul = up[x - bpp:x] if x else np.zeros(bpp, np.int32)
                pred = _paeth(left, b, ul)
            row[x:x + bpp] = (row[x:x + bpp] + pred) & 255
        out[y] = row.astype(np.uint8)
        y += 1
    return out


def decode_png(data: bytes, name: str = '<bytes>') -> np.ndarray:
    """The pixels of a PNG: (H, W) for grey, (H, W, 2) grey and alpha,
    (H, W, 3) RGB (palette files are expanded to it), (H, W, 4) RGBA."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack('>I', data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: bad CRC in chunk {kind!r}")
        pos += 12 + n
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{name}: {depth}-bit PNG is not supported "
                         f"(8-bit only)")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    if color_type not in _CHANNELS:
        raise ValueError(f"{name}: bad PNG colour type {color_type}")
    ch = _CHANNELS[color_type]
    px = _unfilter(zlib.decompress(b''.join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if color_type == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        return palette[px[..., 0]]
    return px[..., 0] if ch == 1 else px


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's 8-bit RGB to grey (no gamma): the weighted sum >> 15."""
    r, g, b = (rgb[..., k].astype(np.int32) for k in range(3))
    wr, wg, wb = GRAY_WEIGHTS
    return ((wr * r + wg * g + wb * b) >> 15).astype(np.uint8)


def read_png(path: str, mode: str = 'color') -> np.ndarray:
    """A PNG file as (H, W, 3) RGB ('color') or (H, W) grey ('gray')."""
    with open(path, 'rb') as f:
        return as_mode(decode_png(f.read(), str(path)), mode)


def as_mode(px: np.ndarray, mode: str) -> np.ndarray:
    """Decoded PNG pixels as (H, W, 3) RGB ('color') or (H, W) grey
    ('gray'), the alpha channel dropped."""
    if px.ndim == 3 and px.shape[2] in (2, 4):   # drop alpha
        px = px[..., :-1]
        if px.shape[2] == 1:
            px = px[..., 0]
    if mode == 'gray':
        return px if px.ndim == 2 else rgb_to_gray(px)
    if mode == 'color':
        return np.repeat(px[..., None], 3, axis=2) if px.ndim == 2 else px
    raise ValueError(f"mode must be 'color' or 'gray', not {mode!r}")
