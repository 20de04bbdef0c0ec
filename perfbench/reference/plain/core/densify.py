# Frozen copy of gsavatar_torch/core/densify.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""Adaptive density control on the fixed-capacity arena.

Counterpart of `gsavatar/core/densify.py`: `add_stats`, `add_stats_prefix`,
`densify_and_prune` and `reset_opacity`, slot for slot.

* clone: grad-norm >= threshold and max scale <= percent_dense * extent;
  the raw row is copied into a free slot.
* split: grad-norm >= threshold and max scale > percent_dense * extent;
  child 1 overwrites the parent, child 2 takes a free slot, both at
  parent xyz + R (scale * eps) with scale / 1.6. The draws are explicit
  (`eps1`, `eps2`, (N, 3) standard normal, row i for slot i): torch cannot
  replay `jax.random.PRNGKey(iteration)`, so the caller draws them (the
  training driver from the state's generator, the tests from JAX's key).
* prune: opacity < min_opacity, and with `use_screen_size_prune` a world
  size > 0.1 * extent (the JAX package's reading of the reference, whose
  screen-radius term is zeroed before it is read).
* compaction: a stable sort of the alive slots to a contiguous prefix; the
  params and Adam moments permute, the statistics and `nn_ix` are reset
  (the caller refreshes the neighbours).

Clones take the free slots in ascending order, second children the next
ones; what does not fit is dropped and counted in `n_dropped`, and a split
whose child 2 has no slot leaves its parent untouched. Every touched slot
gets zero Adam moments. Like the JAX package, nothing here reads a value
back to the host: the slot lists are fixed-size (N) index tensors, so the
driver's one read of the `info` counts is the only sync of a densify. The
result is new tensors, the arguments are left as they were."""
from __future__ import annotations

from typing import Tuple

import torch

from perfbench.reference.plain.utils import transforms as T
from .gaussians import GaussianAux, GaussianParams
from .optim import ArenaAdamState, zero_moments


def add_stats(aux: GaussianAux, means2d_grad, radii) -> GaussianAux:
    """Accumulate the screen-space gradient norm, the visible count and the
    largest screen radius of every visible alive Gaussian (all N rows)."""
    vis = (radii > 0) & aux.alive
    gnorm = torch.linalg.vector_norm(means2d_grad[:, :2], dim=-1)
    return aux.replace(
        xyz_gradient_accum=aux.xyz_gradient_accum
        + torch.where(vis, gnorm, 0.0),
        denom=aux.denom + vis.to(torch.float32),
        max_radii2d=torch.where(vis, torch.maximum(
            aux.max_radii2d, radii.to(torch.float32)), aux.max_radii2d))


def add_stats_prefix(aux: GaussianAux, means2d_grad, radii) -> GaussianAux:
    """`means2d_grad` (b, 2) and `radii` (b,) cover the first b arena rows
    (the alive prefix); the rows after them keep their statistics."""
    b = radii.shape[0]
    head = add_stats(aux.map(lambda x: x[:b]), means2d_grad, radii)

    def prefix(name):
        full = getattr(aux, name)
        return torch.cat([getattr(head, name), full[b:]])

    return aux.replace(**{k: prefix(k) for k in (
        'xyz_gradient_accum', 'denom', 'max_radii2d')})


def _slots(mask, fill: int):
    """The ascending indices of the True entries of `mask` (N,), in the
    first slots of an (N,) int64 tensor, `fill` in the rest
    (`jnp.nonzero(mask, size=N, fill_value=fill)`), without a host read."""
    n = mask.shape[0]
    dst = torch.where(mask, torch.cumsum(mask, 0) - 1, n)
    out = torch.full((n + 1,), fill, dtype=torch.long, device=mask.device)
    out.scatter_(0, dst, torch.arange(n, device=mask.device))
    return out[:n]


def _put_rows(full, rows, dst):
    """full[dst[i]] = rows[i], dropping dst == N (out of place)."""
    ext = torch.cat([full, full[:1]])
    ext.index_copy_(0, dst, rows)
    return ext[:full.shape[0]]


def _put_mask(mask, dst):
    """mask with mask[dst[i]] = True, dropping dst == N."""
    ext = torch.cat([mask, mask[:1]])
    ext[dst] = True
    return ext[:mask.shape[0]]


def densify_and_prune(params: GaussianParams, aux: GaussianAux,
                      adam: ArenaAdamState, eps1, eps2, *,
                      grad_threshold: float, min_opacity: float,
                      extent: float, percent_dense: float,
                      use_screen_size_prune: bool
                      ) -> Tuple[GaussianParams, GaussianAux,
                                 ArenaAdamState, dict]:
    """One densify round; returns (params, aux, adam, info) with `info` the
    0-d int64 tensors n_cloned, n_split, n_dropped, n_pruned, n_alive."""
    N = params.xyz.shape[0]
    dev = params.xyz.device
    alive = aux.alive
    grads = aux.xyz_gradient_accum / torch.clamp_min(aux.denom, 1e-20)
    grads = torch.where(aux.denom > 0, grads, 0.0)

    # scale (and the split children's scale) is read before the clones land,
    # rotation and xyz after, as in the JAX package
    scale = torch.exp(params.scaling)
    max_scale = scale.amax(dim=1)
    hot = alive & (grads >= grad_threshold)
    clone_sel = hot & (max_scale <= percent_dense * extent)
    split_sel = hot & (max_scale > percent_dense * extent)

    free_slots = _slots(~alive, N)
    n_free = (~alive).sum()
    slot_ids = torch.arange(N, device=dev)

    # ---- clones: raw rows copied into the first free slots ---------------
    clone_src = _slots(clone_sel, 0)
    n_clone_want = clone_sel.sum()
    n_clone = torch.minimum(n_clone_want, n_free)
    clone_dst = torch.where(slot_ids < n_clone, free_slots, N)
    params = params.map(lambda x: _put_rows(x, x[clone_src], clone_dst))
    new_alive = _put_mask(alive, clone_dst)

    # ---- splits: child 2 into the next free slots, child 1 over the parent
    n_split_want = split_sel.sum()
    n_split = torch.minimum(n_split_want, n_free - n_clone)
    split_src = _slots(split_sel, 0)
    split_ok = slot_ids < n_split
    child2_dst = torch.where(
        split_ok, free_slots[torch.clamp_max(n_clone + slot_ids, N - 1)], N)

    rot = T.quat_to_rotmat(params.rotation)

    def child_xyz(xyz, eps):
        # the draw of row i goes to the children of slot i (the parent)
        return xyz + (rot @ (scale * eps)[..., None])[..., 0]

    new_scaling = torch.log(scale / (0.8 * 2))
    child2 = params.replace(xyz=child_xyz(params.xyz, eps2),
                            scaling=new_scaling)
    params = GaussianParams(**{
        f: _put_rows(getattr(params, f), getattr(child2, f)[split_src],
                     child2_dst)
        for f in ('xyz', 'features_dc', 'features_rest', 'scaling',
                  'rotation', 'opacity')})
    new_alive = _put_mask(new_alive, child2_dst)

    placed_parent = _put_mask(torch.zeros(N, dtype=torch.bool, device=dev),
                              torch.where(split_ok, split_src, N))
    c1_xyz = child_xyz(params.xyz, eps1)
    params = params.replace(
        xyz=torch.where(placed_parent[:, None], c1_xyz, params.xyz),
        scaling=torch.where(placed_parent[:, None], new_scaling,
                            params.scaling))

    touched = _put_mask(_put_mask(placed_parent, clone_dst), child2_dst)
    adam = zero_moments(adam, touched)

    # ---- prune -------------------------------------------------------------
    opacity = torch.sigmoid(params.opacity)[:, 0]
    prune = new_alive & (opacity < min_opacity)
    if use_screen_size_prune:
        max_scale_new = torch.exp(params.scaling).amax(dim=1)
        prune = prune | (new_alive & (max_scale_new > 0.1 * extent))
    new_alive = new_alive & ~prune

    # ---- compaction: alive slots to a contiguous prefix, in slot order ----
    order = torch.argsort((~new_alive).to(torch.int32), stable=True)
    params = params.map(lambda x: x[order])
    adam = ArenaAdamState(m=adam.m.map(lambda x: x[order]),
                          v=adam.v.map(lambda x: x[order]), step=adam.step)
    new_alive = new_alive[order]
    zeros = torch.zeros(N, device=dev)
    aux = GaussianAux(alive=new_alive, max_radii2d=zeros,
                      xyz_gradient_accum=zeros.clone(), denom=zeros.clone(),
                      nn_ix=torch.zeros_like(aux.nn_ix))
    info = {'n_cloned': n_clone, 'n_split': n_split,
            'n_dropped': (n_clone_want - n_clone) + (n_split_want - n_split),
            'n_pruned': prune.sum(), 'n_alive': new_alive.sum()}
    return params, aux, adam, info


def reset_opacity(params: GaussianParams, adam: ArenaAdamState, alive):
    """Clamp the alive opacities to <= 0.01 and zero the opacity Adam
    moments of every slot."""
    op = torch.sigmoid(params.opacity)
    new = T.inverse_sigmoid(torch.clamp_max(op, 0.01))
    params = params.replace(opacity=torch.where(alive[:, None], new,
                                                params.opacity))
    adam = zero_moments(adam, torch.ones_like(alive), fields=('opacity',))
    return params, adam
