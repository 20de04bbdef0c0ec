# Frozen copy of gsavatar_torch/ops/segsum_blocked.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
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


def segment_sum_sorted_blocked(values, seg_ids, num_segments: int):
    """The plain version on every device."""
    return segment_sum_sorted_blocked_plain(values, seg_ids, num_segments)
