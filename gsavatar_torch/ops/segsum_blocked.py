"""K3, the sorted segment sum: CUDA kernel and plain version.

Counterpart of `gsavatar/ops/segsum_pallas.py:segment_sum_sorted_blocked`.
Both functions here take values (M, C) f32 row-major and seg_ids (M,) int32
sorted ascending, and return the (num_segments, C) f32 sums of each
segment's rows. Ids >= num_segments are dropped and their rows never reach
a sum, whatever they hold (NaN included).

`segment_sum_sorted_blocked` launches the hand-written Hopper kernel
(`gsavatar_torch/csrc/segsum.cu`) for CUDA tensors and counts its launches
in `segment_sum_sorted_blocked.launches`. The kernel splits the rows into
chunks (`chunk_rows`), one warp each; the partial sums of each chunk's
first and last segment go to two carry records per chunk, which the
wrapper allocates (`carry_records`) and a second pass adds in chunk order, so
the sums come out the same bit for bit on every run. Only for CPU tensors
does it take the plain version, `segment_sum_sorted_blocked_plain`: the
JAX package's portable formulation (`gsavatar/ops/segsum.py:
segment_sum_sorted`: mask, cumsum, searchsorted, difference), accumulated
in float64, so that it stays an exact enough reference at millions of
rows."""
from __future__ import annotations

import ctypes

import torch

# rows of a chunk, one warp of the kernel each: 256, or 64 for inputs under
# SMALL_ROWS rows, which 256-row chunks would spread over too few warps
CHUNK_ROWS, SMALL_CHUNK_ROWS, SMALL_ROWS = 256, 64, 1 << 20
# the column counts the kernel is built for: the hash-table gradient (2),
# the AIAP gathers (3 and 6) and the pair gradients (9)
WIDTHS = (2, 3, 6, 9)


def segment_sum_sorted_blocked_plain(values, seg_ids, num_segments: int):
    """Plain PyTorch K3: differences of a float64 running sum at each
    segment's end. The running sum starts from a zero row, as the JAX
    function pads it, so that M = 0 rows give zeros."""
    keep = (seg_ids < num_segments)[:, None]
    v = torch.where(keep, values.double(), 0.0)
    csum = torch.cat([v.new_zeros((1, v.shape[1])), torch.cumsum(v, dim=0)])
    end = torch.searchsorted(
        seg_ids, torch.arange(num_segments, dtype=seg_ids.dtype,
                              device=seg_ids.device), side='right')
    start = torch.cat([torch.zeros_like(end[:1]), end[:-1]])
    return (csum[end] - csum[start]).float()


def chunk_rows(num_rows: int) -> int:
    """The rows of each of the kernel's chunks for an input of num_rows."""
    return SMALL_CHUNK_ROWS if num_rows < SMALL_ROWS else CHUNK_ROWS


def carry_records(num_rows: int) -> int:
    """The kernel's carry records for M = num_rows rows: two per chunk (the
    chunk's first and last segment), each an id and a row of values."""
    return 2 * (-(-num_rows // chunk_rows(num_rows)))


def _launcher():
    """The kernel's C entry point, its argument types set once."""
    from gsavatar_torch import kernels
    fn = kernels.load('segsum').gs_segsum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    if values.data_ptr() % 16:
        raise ValueError("values must be 16-byte aligned")
    if not 0 <= num_segments < 2 ** 31 // values.shape[1]:
        raise ValueError(f"num_segments {num_segments} out of range")
    num_rows, n_cols = values.shape
    n_rec = carry_records(num_rows)
    # one allocation: the output, then the carry records' ids (int32) and
    # values, which the kernel reads at byte offsets into the same buffer
    n_out = num_segments * n_cols
    buf = torch.empty(n_out + n_rec * (1 + n_cols), dtype=torch.float32,
                      device=values.device)
    out = buf[:n_out].view(num_segments, n_cols)
    rec_id = buf.data_ptr() + 4 * n_out
    err = _launcher()(values.data_ptr(), seg_ids.data_ptr(), buf.data_ptr(),
                      rec_id, rec_id + 4 * n_rec, num_rows, n_cols,
                      num_segments,
                      torch.cuda.current_stream(values.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segsum launch failed: CUDA error {err}")
    segment_sum_sorted_blocked.launches += 1
    return out


segment_sum_sorted_blocked.launches = 0
