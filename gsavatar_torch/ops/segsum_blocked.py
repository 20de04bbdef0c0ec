"""K3, the sorted segment sum: CUDA kernel and plain version.

Counterpart of `gsavatar/ops/segsum_pallas.py:segment_sum_sorted_blocked`.
Both functions here take values (M, C) f32 row-major and seg_ids (M,) int32
sorted ascending, and return the (num_segments, C) f32 sums of each
segment's rows. Ids >= num_segments are dropped and their rows never reach
a sum, whatever they hold (NaN included).

`segment_sum_sorted_blocked` launches the hand-written Hopper kernel
(`gsavatar_torch/csrc/segsum.cu`) for CUDA tensors and counts its launches
in `segment_sum_sorted_blocked.launches`. Only for CPU tensors does it take
the plain version, `segment_sum_sorted_blocked_plain`: the JAX package's
portable formulation (`gsavatar/ops/segsum.py:segment_sum_sorted`: mask,
cumsum, searchsorted, difference), accumulated in float64, so that it stays
an exact enough reference at millions of rows."""
from __future__ import annotations

import ctypes

import torch

SEG_BLOCK = 512     # output segments per block of the kernel
# the column counts the kernel is built for: the hash-table gradient (2),
# the AIAP gathers (3 and 6) and the pair gradients (9)
WIDTHS = (2, 3, 6, 9)


def segment_sum_sorted_blocked_plain(values, seg_ids, num_segments: int):
    """Plain PyTorch K3: differences of a float64 running sum at each
    segment's end."""
    keep = (seg_ids < num_segments)[:, None]
    v = torch.where(keep, values.double(), 0.0)
    csum = torch.cat([torch.zeros_like(v[:1]), torch.cumsum(v, dim=0)])
    end = torch.searchsorted(
        seg_ids, torch.arange(num_segments, dtype=seg_ids.dtype,
                              device=seg_ids.device), side='right')
    start = torch.cat([torch.zeros_like(end[:1]), end[:-1]])
    return (csum[end] - csum[start]).float()


def block_starts(seg_ids, num_segments: int):
    """Row span bounds (NB + 1,) int32 of the kernel's blocks of 512
    segments: the first row whose id reaches each block's first segment
    (bounds past the last segment clamp to num_segments, so that dropped
    ids fall after the last span)."""
    nb = (num_segments + SEG_BLOCK - 1) // SEG_BLOCK
    bounds = torch.clamp_max(
        torch.arange(nb + 1, dtype=torch.int32, device=seg_ids.device)
        * SEG_BLOCK, num_segments)
    return torch.searchsorted(seg_ids, bounds, side='left', out_int32=True)


def segment_sum_sorted_blocked(values, seg_ids, num_segments: int):
    """values (M, C) f32, seg_ids (M,) int32 sorted -> (num_segments, C)
    f32. CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if values.device.type == 'cpu':
        return segment_sum_sorted_blocked_plain(values, seg_ids,
                                                num_segments)
    if values.device.type != 'cuda':
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not "
                         f"{values.device}")
    if seg_ids.device != values.device:
        raise ValueError("values and seg_ids are on different devices")
    if values.dtype != torch.float32 or values.ndim != 2 \
            or values.shape[1] not in WIDTHS:
        raise ValueError(f"values must be f32 (M, C) with C in {WIDTHS}, "
                         f"got {values.dtype} {tuple(values.shape)}")
    if seg_ids.dtype != torch.int32 or seg_ids.shape != values.shape[:1]:
        raise ValueError(f"seg_ids must be int32 ({values.shape[0]},), got "
                         f"{seg_ids.dtype} {tuple(seg_ids.shape)}")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("K3 takes contiguous tensors")
    if not 0 <= num_segments < 2 ** 31 // values.shape[1]:
        raise ValueError(f"num_segments {num_segments} out of range")
    from gsavatar_torch import kernels
    lib = kernels.load('segsum')
    lib.gs_segsum.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gs_segsum.restype = ctypes.c_int
    starts = block_starts(seg_ids, num_segments)
    out = torch.empty((num_segments, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.gs_segsum(values.data_ptr(), seg_ids.data_ptr(),
                        starts.data_ptr(), out.data_ptr(), values.shape[1],
                        num_segments, stream)
    if err != 0:
        raise RuntimeError(f"segsum launch failed: CUDA error {err}")
    segment_sum_sorted_blocked.launches += 1
    return out


segment_sum_sorted_blocked.launches = 0
