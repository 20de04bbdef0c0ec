# Frozen copy of gsavatar_torch/ops/knn.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Brute-force nearest neighbours, chunked over the queries.

Counterpart of `gsavatar/ops/knn.py:mean_dist3`, `knn_self` and `nn_index`:
||x - y||^2 = ||x||^2 + ||y||^2 - 2 x.y with the cross term as one matrix
product per chunk of queries, which bounds the (chunk, M) distance matrix.
Ties between equal distances may order neighbours differently from the JAX
package; the distances agree."""
from __future__ import annotations

import torch


def mean_dist3(points, chunk: int = 1024):
    """Mean squared distance of each point to its 3 nearest other points
    (the simple-knn `distCUDA2` contract). (N, 3) -> (N,)."""
    p_sq = (points * points).sum(-1)
    out = []
    for s in range(0, points.shape[0], chunk):
        q = points[s:s + chunk]
        d = (q * q).sum(-1)[:, None] + p_sq[None, :] - 2.0 * (q @ points.T)
        near = torch.topk(d, 4, dim=1, largest=False).values[:, 1:4]
        out.append(near.clamp_min(0.0).mean(dim=1))
    return torch.cat(out)


def nn_index(query, points, chunk: int = 1024):
    """Index (N,) int32 of the nearest of `points` (M, 3) to each query
    (N, 3); the first of equal distances."""
    p_sq = (points * points).sum(-1)
    out = []
    for s in range(0, query.shape[0], chunk):
        q = query[s:s + chunk]
        d = (q * q).sum(-1)[:, None] + p_sq[None, :] - 2.0 * (q @ points.T)
        out.append(torch.argmin(d, dim=1))
    return torch.cat(out).to(torch.int32)


def knn_self(x, k: int, chunk: int = 1024, mask=None):
    """Indices (N, k) int32 of the k nearest neighbours of each point within
    x, the point itself excluded (the first of the k + 1 nearest). `mask`
    (N,) bool keeps dead arena slots from being anyone's neighbour; with
    fewer than k other points the last neighbour repeats."""
    pts = x if mask is None else torch.where(mask[:, None], x, 1e6)
    kq = min(k + 1, pts.shape[0])
    p_sq = (pts * pts).sum(-1)
    out = []
    for s in range(0, pts.shape[0], chunk):
        q = pts[s:s + chunk]
        d = (q * q).sum(-1)[:, None] + p_sq[None, :] - 2.0 * (q @ pts.T)
        out.append(torch.topk(d, kq, dim=1, largest=False).indices)
    idx = torch.cat(out)[:, 1:kq].to(torch.int32)
    if idx.shape[1] < k:
        pad = idx[:, -1:] if idx.shape[1] else torch.zeros_like(idx[:, :1])
        idx = torch.cat([idx, pad.expand(-1, k - idx.shape[1])], dim=1)
    return idx
