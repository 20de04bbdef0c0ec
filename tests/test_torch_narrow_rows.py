"""K4's plain version against the JAX tool's Pallas kernel, and its
wrapper's contract, on the CPU.

`tools/profile_narrow_dma.py:_kernel` runs through `pl.pallas_call(...,
interpret=True)` with the tool's own specs at grid=(4,) on a (4096, 12)
input (the kernel body does not depend on P). Its live output is
`[:, 0, :12]`. Tolerance: 1e-5 of each output's sum of |x| (the two sum in
another order)."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import torch_dist_workers  # noqa: F401  (torch on one thread)

from gsavatar_torch.tools import profile_narrow_dma as K4

ROOT = Path(__file__).resolve().parent.parent
N_BLOCKS = 4


@pytest.fixture(scope='module')
def tool():
    """The JAX tool, imported from its file as it is. Its import turns on the
    persistent compilation cache; that is switched off here, so that the
    rest of this test process compiles as it would without the tool."""
    from gsavatar.utils import jax_cache
    done = jax_cache._DONE
    jax_cache._DONE = True
    try:
        spec = importlib.util.spec_from_file_location(
            'profile_narrow_dma', ROOT / 'tools' / 'profile_narrow_dma.py')
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax_cache._DONE = done
    return mod


def _jax_kernel(tool, x):
    return pl.pallas_call(
        tool._kernel,
        grid=(N_BLOCKS,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec((1, 8, 128), lambda b: (b, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((N_BLOCKS, 8, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((2, tool.CHUNK, tool.COLS), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True,
    )(x)


def test_plain_version_matches_the_pallas_kernel(tool):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(N_BLOCKS * 1024, 12)).astype(np.float32)
    want = np.asarray(_jax_kernel(tool, jnp.asarray(x)))
    assert want.shape == (N_BLOCKS, 8, 128)
    # rows 1-7 repeat row 0, lanes 12-127 are zero
    assert np.array_equal(want[:, 1:, :12],
                          np.broadcast_to(want[:, :1, :12], (N_BLOCKS, 7, 12)))
    assert not want[:, :, 12:].any()
    got = K4.run(torch.from_numpy(x))
    assert got.shape == (N_BLOCKS, 12) and got.dtype == torch.float32
    mag = np.abs(x).reshape(N_BLOCKS, 1024, 12).sum(1)
    assert np.all(np.abs(got.numpy() - want[:, 0, :12]) <= 1e-5 * mag)
    assert K4.run.launches == 0


@pytest.mark.parametrize('x', [
    torch.zeros((1000, 12)),                         # P not a multiple
    torch.zeros((0, 12)),                            # empty
    torch.zeros((1024, 12), dtype=torch.float64),    # not f32
    torch.zeros((1024, 16)),                         # width not 12
    torch.zeros((12, 1024)).T,                       # not contiguous
    torch.zeros((1024 * 12 + 1,))[1:].view(1024, 12),  # not 16-byte aligned
], ids=['rows', 'empty', 'dtype', 'width', 'strides', 'alignment'])
def test_wrapper_rejects_what_the_kernel_does_not_take(x):
    with pytest.raises(ValueError):
        K4.run(x)
    with pytest.raises(ValueError):
        K4.run_plain(x)


def test_wrapper_raises_off_cuda_and_cpu():
    with pytest.raises(ValueError):
        K4.run(torch.zeros((1024, 12), device='meta'))


def test_moved_bytes_at_the_probe_shape():
    """The bound's bytes at P = 2^21: 100,663,296 read, 98,304 written;
    over 3.35 TB/s, 0.0301 ms."""
    assert K4.moved_bytes(K4.P) == 100_663_296 + 98_304
    assert round(K4.moved_bytes(K4.P) / K4.PEAK_BYTES * 1e3, 4) == 0.0301
