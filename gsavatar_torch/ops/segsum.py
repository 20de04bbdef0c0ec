"""Segment sums for gather transposes.

Counterpart of `gsavatar/ops/segsum.py`. Every backward pass that autograd
would turn into a scatter-add over millions of rows (the hash-table
gradient, the pair gradients, the AIAP neighbour gathers) is instead: sort
by segment id, gather the value rows by the sort's permutation, and one
launch of K3 (`segsum_blocked.segment_sum_sorted_blocked`), which sums each
segment in f32. torch has no multi-operand sort, so the values follow the
ids through the permutation `torch.sort` returns."""
from __future__ import annotations

import torch

from gsavatar_torch import tracing
from .segsum_blocked import segment_sum_sorted_blocked


def segment_sum_sorted(values, seg_ids, num_segments: int):
    """values (M, C) f32, seg_ids (M,) SORTED ascending (ids >=
    num_segments are dropped). Returns (num_segments, C) f32."""
    return segment_sum_sorted_blocked(values.contiguous(),
                                      seg_ids.to(torch.int32).contiguous(),
                                      num_segments)


def segment_sum(values, seg_ids, num_segments: int):
    """Unsorted variant: one sort of the ids, the value rows gathered by its
    permutation, then K3."""
    ids, perm = torch.sort(seg_ids.to(torch.int32))
    return segment_sum_sorted(values[perm], ids, num_segments)


def segment_sum_leveled(values, seg_ids_local, level_size: int):
    """The transpose of L independent gathers from an (L * level_size, C)
    table: values (L, Mp, C), seg_ids_local (L, Mp) in [0, level_size).
    Each level is sorted on its own along the last axis; with the level
    offsets added the flat ids are sorted globally, so one K3 launch serves
    every level. Returns (L * level_size, C) f32."""
    L, Mp, C = values.shape
    ids, perm = torch.sort(seg_ids_local.to(torch.int32), dim=1)
    vals = torch.gather(values, 1, perm[..., None].expand(L, Mp, C))
    offs = torch.arange(L, dtype=torch.int32,
                        device=ids.device)[:, None] * level_size
    return segment_sum_sorted_blocked(vals.reshape(L * Mp, C),
                                      (ids + offs).reshape(-1),
                                      L * level_size)


class GatherRows(torch.autograd.Function):
    """src (S, C)[idx] -> (M, C). Indices >= S read row S - 1 forward and
    are dropped in the backward, which is `segment_sum` (sort + K3) instead
    of autograd's scatter-add."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = src.shape[0]
        return src[torch.clamp_max(idx, src.shape[0] - 1)]

    @staticmethod
    def backward(ctx, ct):
        idx, = ctx.saved_tensors
        with tracing.span('backward/segsum'):
            return segment_sum(ct, idx, ctx.num_rows), None


def gather_rows(src, idx):
    return GatherRows.apply(src, idx)
