"""Binary PLY I/O in the standard 3DGS attribute layout.

The port's copy of `gsavatar/utils/ply.py` (numpy only): the attribute
names and order of the 3DGS tooling (x y z, nx ny nz, f_dc_*, f_rest_*
channel-major, opacity, scale_*, rot_*) in little-endian binary, so that
both packages write the same bytes for the same arena. `save_arena_ply`
takes the port's tensors (any device) and writes the alive slots."""
from __future__ import annotations

import os

import numpy as np


def _write_ply(path: str, names, data: np.ndarray):
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {data.shape[0]}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header", ""]
    with open(path, 'wb') as f:
        f.write("\n".join(header).encode('ascii'))
        f.write(np.ascontiguousarray(data, '<f4').tobytes())


_DTYPES = {'float': '<f4', 'float32': '<f4', 'double': '<f8', 'uchar': 'u1',
           'uint8': 'u1', 'int': '<i4', 'uint': '<u4', 'short': '<i2',
           'ushort': '<u2', 'char': 'i1'}


def _read_ply(path: str):
    with open(path, 'rb') as f:
        raw = f.read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    n, names, fmt = 0, [], None
    for ln in raw[:end].decode('ascii').splitlines():
        parts = ln.split()
        if not parts:
            continue
        if parts[0] == 'format':
            fmt = parts[1]
        elif parts[0] == 'element' and parts[1] == 'vertex':
            n = int(parts[2])
        elif parts[0] == 'property' and len(parts) == 3:
            names.append((parts[2], parts[1]))
    dt = np.dtype([(nm, _DTYPES[t]) for nm, t in names])
    if fmt == 'binary_little_endian':
        arr = np.frombuffer(raw[end:end + n * dt.itemsize], dtype=dt)
    elif fmt == 'ascii':
        flat = np.array(raw[end:].decode('ascii').split(),
                        dtype=np.float64).reshape(n, len(names))
        arr = np.zeros(n, dtype=dt)
        for i, (nm, _) in enumerate(names):
            arr[nm] = flat[:, i]
    else:
        raise ValueError(f"unsupported ply format {fmt}")
    return arr, [nm for nm, _ in names]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, 'detach') else np.asarray(x)


def save_arena_ply(path: str, params, aux):
    """Write the alive arena slots in the 3DGS layout."""
    alive = _np(aux.alive)
    take = lambda x: _np(x)[alive]
    xyz = take(params.xyz)
    n = xyz.shape[0]
    # (N, R, C) -> channel-major (C * R), as torch's transpose(1, 2)
    f_dc = take(params.features_dc).transpose(0, 2, 1).reshape(n, -1)
    f_rest = take(params.features_rest).transpose(0, 2, 1).reshape(n, -1)
    scale, rot = take(params.scaling), take(params.rotation)
    names = (['x', 'y', 'z', 'nx', 'ny', 'nz']
             + [f'f_dc_{i}' for i in range(f_dc.shape[1])]
             + [f'f_rest_{i}' for i in range(f_rest.shape[1])]
             + ['opacity']
             + [f'scale_{i}' for i in range(scale.shape[1])]
             + [f'rot_{i}' for i in range(rot.shape[1])])
    data = np.concatenate([xyz, np.zeros_like(xyz), f_dc, f_rest,
                           take(params.opacity), scale, rot], axis=1)
    _write_ply(path, names, data)


def _by_index(names, prefix):
    return sorted([nm for nm in names if nm.startswith(prefix)],
                  key=lambda s: int(s.split('_')[-1]))


def load_gaussian_ply(path: str, max_sh_degree: int = 3) -> dict:
    """A 3DGS ply as dense numpy arrays: xyz, features_dc, features_rest,
    opacity, scaling, rotation."""
    arr, names = _read_ply(path)
    n = len(arr)
    col = lambda prefix: np.stack([arr[nm] for nm in _by_index(names, prefix)],
                                  axis=1).astype(np.float32)
    xyz = np.stack([arr['x'], arr['y'], arr['z']], axis=1).astype(np.float32)
    f_dc = col('f_dc_')
    f_rest = col('f_rest_') if _by_index(names, 'f_rest_') \
        else np.zeros((n, 0), np.float32)
    ch = f_dc.shape[1]
    rows = f_rest.shape[1] // max(ch, 1)
    # stored channel-major: (N, C, R) -> (N, R, C)
    return {'xyz': xyz,
            'features_dc': f_dc.reshape(n, ch, 1).transpose(0, 2, 1),
            'features_rest': f_rest.reshape(n, ch, rows).transpose(0, 2, 1),
            'opacity': np.asarray(arr['opacity'], np.float32)[:, None],
            'scaling': col('scale_'), 'rotation': col('rot_')}


def save_point_cloud_ply(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """A coloured point cloud: x y z, zero normals, red green blue."""
    names = ['x', 'y', 'z', 'nx', 'ny', 'nz', 'red', 'green', 'blue']
    _write_ply(path, names,
               np.concatenate([xyz, np.zeros_like(xyz), rgb], axis=1))
