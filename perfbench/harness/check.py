"""The comparison that decides `correct`: each number the reference check
reads against its limit (`cells/<workload>.json`). A number that is not
finite, or above its limit, fails the run; a limit with no reading fails
it too."""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {'value', 'limit'}}) over the limited numbers."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, float('nan'))
        checks[name] = {'value': value, 'limit': limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Each leaf's |norm(prog) - norm(ref)|, against the larger of its
    reference norm and the median leaf's."""
    nr = {k: norm(ref[k]) for k in leaves}
    floor = float(torch.tensor(sorted(nr.values())).median())
    return {k: abs(norm(prog[k]) - nr[k]) / max(nr[k], floor, 1e-30)
            for k in leaves}


def worst_leaf_gap(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor],
                   leaves: Sequence[str]) -> float:
    """The largest of `leaf_gaps`."""
    return max(leaf_gaps(prog, ref, leaves).values())


def moved_leaves(grads: Dict[str, torch.Tensor], share: float = 1e-3):
    """The leaves whose reference gradient is over `share` of the median
    leaf's: the others move under Adam by round-off alone."""
    n = {k: norm(v) for k, v in grads.items()}
    med = float(torch.tensor(sorted(n.values())).median())
    return [k for k, v in n.items() if v > share * med]


def densify_gaps(prog, ref, fields: Sequence[str]) -> Dict[str, float]:
    """After a densify round and its `refresh_knn`: the share of the slots
    whose alive flag differs, against the reference's alive count
    (`alive_gap`); the worst field's gap of norms over each side's alive
    slots (`arena_gap`, by `worst_leaf_gap`), steady where one slot flips
    at a threshold and shifts the compacted rows; and the share of the
    alive slots whose cached neighbours differ from those the reference
    finds over the same side's arena (`knn_gap`: `prog['nn_ref']`). A
    side with no round reads nan."""
    if prog is None or ref is None:
        return {k: float('nan') for k in ('alive_gap', 'arena_gap',
                                          'knn_gap')}
    pa, ra = prog['alive'], ref['alive']
    alive_gap = float((pa != ra).sum()) / max(float(ra.sum()), 1.0)
    return {'alive_gap': alive_gap,
            'arena_gap': worst_leaf_gap(
                {f: prog[f][pa] for f in fields},
                {f: ref[f][ra] for f in fields}, fields),
            'knn_gap': neighbour_gap(prog['nn_ix'], prog['nn_ref'], pa)}


def neighbour_gap(cached, found, alive) -> float:
    """The share of the alive slots (a prefix) whose set of cached
    neighbours differs from the set found."""
    n = int(alive.sum())
    a = torch.sort(cached[:n].long(), dim=1).values
    b = torch.sort(found[:n].long(), dim=1).values
    return float((a != b).any(dim=1).sum()) / max(n, 1)


def frame_gaps(prog, ref) -> Dict[str, float]:
    """Playback, over (camera, render) pairs of the compared frames: the
    worst largest gap of the bone transforms (against their largest
    magnitude), of the deformed positions (likewise) and of the colours,
    and the worst mean absolute gap of the image and of the alpha."""
    out = {'pose_gap': 0.0, 'xyz_gap': 0.0, 'color_gap': 0.0,
           'image_mae': 0.0, 'alpha_mae': 0.0}
    if not prog:
        return {k: float('nan') for k in out}     # nothing was compared
    for (pc, p), (rc, r) in zip(prog, ref):
        pb, rb = pc.bone_transforms, rc.bone_transforms
        out['pose_gap'] = max(out['pose_gap'], float(
            (pb - rb).abs().max() / rb.abs().max()))
        out['image_mae'] = max(out['image_mae'], float(
            (p.render - r.render).abs().mean()))
        out['alpha_mae'] = max(out['alpha_mae'], float(
            (p.opacity_render - r.opacity_render).abs().mean()))
        px, rx = p.deformed_gaussians.get_xyz, r.deformed_gaussians.get_xyz
        out['xyz_gap'] = max(out['xyz_gap'], float(
            (px - rx).abs().max() / rx.abs().max()))
        out['color_gap'] = max(out['color_gap'], float(
            (p.colors - r.colors).abs().max()))
    return out
