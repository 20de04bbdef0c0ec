"""Brute-force nearest-neighbour distances, chunked over the queries.

Counterpart of `gsavatar/ops/knn.py:mean_dist3`:
||x - y||^2 = ||x||^2 + ||y||^2 - 2 x.y with the cross term as one matrix
product per chunk of queries, which bounds the (chunk, M) distance matrix."""
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
