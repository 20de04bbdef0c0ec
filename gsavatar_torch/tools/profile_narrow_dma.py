"""K4, the narrow-row probe: how fast the card streams 48-byte rows.

    python -m gsavatar_torch.tools.profile_narrow_dma

Counterpart of `tools/profile_narrow_dma.py` (`run`, `main`). The JAX tool
asked whether the TPU's DMA engine streams (64, 12) row chunks of a
(2^21, 12) f32 array; on the card the question is how close rows of that
width come to the memory rate. 12 f32 columns is the width of the port's
pair rows (`ops/rasterizer/pairs.py:PAIR_COLS`), which K1, K2 and K3 read,
so the probe's rate is the floor their redesigns aim at.

`run(x)`: x (P, 12) f32, contiguous, 16-byte aligned, P a positive
multiple of 1024 -> (P / 1024, 12) f32, each row the sum of a block of 1024
rows of x (the TPU kernel's live output `[:, 0, :12]`; its (8, 128) padding
existed only for the TPU's tiles). Anything else raises. For CUDA tensors
it launches the hand-written Hopper kernel (`gsavatar_torch/csrc/
narrow_rows.cu`) and counts its launches in `run.launches`; only for CPU
tensors does it take the plain version, `run_plain`, which sums each
block's 16 chunks of 64 rows in the TPU kernel's order.

`main()` prints the kernel's max error against the plain version, its mean
time over 20 launches between CUDA events, the rate it reaches and its
share of the H100's 3.35 TB/s."""
from __future__ import annotations

import ctypes

import torch

P = 1 << 21
COLS = 12
BLOCK = 1024    # rows summed into one output row
CHUNK = 64      # rows per chunk of the TPU kernel's double-buffered DMA
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet


def _check(x):
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != COLS:
        raise ValueError(f"x must be f32 (P, {COLS}), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[0] <= 0 or x.shape[0] % BLOCK:
        raise ValueError(f"P must be a positive multiple of {BLOCK}, got "
                         f"{x.shape[0]}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")


def run_plain(x):
    """Plain PyTorch K4: per block, the 16 chunk sums of 64 rows added in
    the TPU kernel's order."""
    _check(x)
    chunks = x.view(-1, BLOCK // CHUNK, CHUNK, COLS)
    acc = torch.zeros((chunks.shape[0], COLS), dtype=torch.float32,
                      device=x.device)
    for i in range(BLOCK // CHUNK):
        acc = acc + chunks[:, i].sum(dim=1)
    return acc


def run(x):
    """x (P, 12) f32 -> (P / 1024, 12) f32 block sums. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    _check(x)
    if x.device.type == 'cpu':
        return run_plain(x)
    if x.device.type != 'cuda':
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {x.device}")
    from gsavatar_torch import kernels
    lib = kernels.load('narrow_rows')
    lib.gs_narrow_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_longlong, ctypes.c_void_p]
    lib.gs_narrow_rows.restype = ctypes.c_int
    out = torch.empty((x.shape[0] // BLOCK, COLS), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.gs_narrow_rows(x.data_ptr(), out.data_ptr(), x.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"narrow_rows launch failed: CUDA error {err}")
    run.launches += 1
    return out


run.launches = 0


def moved_bytes(n_rows: int) -> int:
    """What K4 must move: every row read once, every block sum written."""
    return n_rows * COLS * 4 + n_rows // BLOCK * COLS * 4


def main():
    from gsavatar_torch.device import resolve_device
    dev = resolve_device()
    x = torch.randn((P, COLS), generator=torch.Generator().manual_seed(0)
                    ).to(dev)
    got = run(x)
    want = run_plain(x)
    err = float((got - want).abs().max())
    print("narrow rows sum works, max err", err)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        run(x)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 20
    rate = moved_bytes(P) / (ms * 1e-3)
    print(f"avg ms {ms:.4f}, {rate / 1e9:.1f} GB/s, "
          f"{rate / PEAK_BYTES:.3f} of 3.35 TB/s")


if __name__ == '__main__':
    main()
