"""Build and load the port's CUDA kernels.

Each `gsavatar_torch/csrc/<name>.cu` has a plain C interface. It is compiled
at first use with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`
into `build/<name>-<hash of the source and the csrc headers>.so` at the
repository root and
loaded with ctypes. Nothing is compiled when this module is imported, and
only the kernels' own launch paths call `load`."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD = Path(__file__).resolve().parent.parent / 'build'
# -Xptxas -v: each kernel's registers, shared memory and spills, in the log
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = shutil.which('nvcc') or os.path.join(cuda_home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    """The library of csrc/<name>.cu, named by a hash of that source and of
    every header under csrc/, so that editing a shared header rebuilds
    every kernel that may include it."""
    h = hashlib.sha1((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD / f'{name}-{h.hexdigest()[:12]}.so'


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources that have no current library, one nvcc
    process per source, all started together. Returns nvcc's output for
    each source it compiled."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = _target(name).with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed, logs = [], {}
    for name, tmp, proc in procs:
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built if need be."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(_target(name)))
    return _loaded[name]
