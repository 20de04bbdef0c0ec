"""Densify, prune, the opacity reset, the neighbour refresh and `nn_index`
of gsavatar_torch against gsavatar's, on the CPU.

A JAX arena of 1024 slots is made from a seed with numpy (params, densify
statistics and Adam moments set so that one call clones, splits and
prunes) and carried to the port with `gsavatar_torch.convert`. The split
draws are JAX's own: `jax.random.split(PRNGKey(iteration))` then
`normal(k, (N, 3))`, as `gsavatar/core/densify.py` draws them, handed to
the port as `eps1` and `eps2`. Two arenas: one with room for every clone
and child, one nearly full, so that clones and splits are dropped.

Tolerances, and why: the alive mask, the counts, every copied row and the
Adam moments exactly (copies and zeros); child xyz and scaling within 1e-6
(a 3x3 product and exp/log, each package in its own order); the reset
opacities within 1e-6 (sigmoid and log); the refreshed neighbours by their
squared distances within 1e-6 (fresh clones sit on their sources, so which
of two equal points is dropped as "self" and the order of equal distances
are tie-breaks); `nn_index` exactly on tie-free points."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_np

from gsavatar_torch import convert
from gsavatar_torch.core import densify as TD
from gsavatar_torch.core.gaussians import K_NEIGHBORS
from gsavatar_torch.ops import knn as tknn
from gsavatar_torch.train import refresh_knn

from gsavatar.core import densify as JD
from gsavatar.core import gaussians as JG
from gsavatar.core import optim as JO
from gsavatar.ops import knn as jknn

CAPACITY = 1024
EXTENT = 3.469298553466797      # the synthetic scene's cameras_extent
KW = dict(grad_threshold=2e-4, min_opacity=0.05, extent=EXTENT,
          percent_dense=0.01)
ITERATION = 500
FIELDS = ('xyz', 'features_dc', 'features_rest', 'scaling', 'rotation',
          'opacity')


def _jax_arena(n_alive, seed):
    """A JAX arena with `n_alive` live slots in front: random params, about
    a fifth of them hot (grad-norm over the threshold), half of those above
    the clone/split scale, some opacities under the prune threshold and some
    world sizes over 0.1 extent, random Adam moments, and dead slots holding
    garbage that must not leak."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    n = CAPACITY
    alive = np.zeros(n, bool)
    alive[:n_alive] = True
    # dead slots in the middle too: the free list is not a suffix
    alive[rng.choice(n_alive, 40, replace=False)] = False
    scaling = rng.uniform(-4.6, -2.6, (n, 3))          # split above -3.36
    scaling[rng.random(n) < 0.03] = -0.5               # world size > 0.35
    params = JG.GaussianParams(
        xyz=jnp.asarray(f32(rng.uniform(-1, 1, (n, 3)))),
        features_dc=jnp.asarray(f32(rng.normal(size=(n, 1, 1)))),
        features_rest=jnp.asarray(f32(rng.normal(size=(n, 31, 1)))),
        scaling=jnp.asarray(f32(scaling)),
        rotation=jnp.asarray(f32(rng.normal(size=(n, 4)))),
        opacity=jnp.asarray(f32(rng.uniform(-4.0, 1.0, (n, 1)))))
    denom = f32(rng.integers(0, 6, n))
    accum = f32(np.where(rng.random(n) < 0.2, 3e-4, 1e-4) * denom
                * rng.uniform(0.9, 1.5, n))
    aux = JG.GaussianAux(
        alive=jnp.asarray(alive),
        max_radii2d=jnp.asarray(f32(rng.uniform(0, 9, n))),
        xyz_gradient_accum=jnp.asarray(accum), denom=jnp.asarray(denom),
        nn_ix=jnp.asarray(rng.integers(0, n, (n, K_NEIGHBORS)).astype(
            np.int32)))
    moments = lambda: JG.GaussianParams(**{
        f: jnp.asarray(f32(rng.normal(size=getattr(params, f).shape)))
        for f in FIELDS})
    adam = JO.ArenaAdamState(m=moments(), v=moments(),
                             step=jnp.asarray(7, jnp.int32))
    return params, aux, adam


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module', params=[(700, False), (700, True),
                                        (1000, False), (1000, True)],
                ids=['room', 'room-screen', 'full', 'full-screen'])
def case(request):
    n_alive, use_ss = request.param
    jp, ja, jadam = _jax_arena(n_alive, seed=n_alive + use_ss)
    key = jax.random.PRNGKey(ITERATION)
    k1, k2 = jax.random.split(key)
    eps1 = torch.from_numpy(np.array(jax.random.normal(k1, (CAPACITY, 3))))
    eps2 = torch.from_numpy(np.array(jax.random.normal(k2, (CAPACITY, 3))))
    tp, ta = convert.arena(_np(jp), _np(ja))
    tadam = convert.arena_adam(_np(jadam))
    before = (tp.map(torch.clone), ta.map(torch.clone))
    inputs = (tp, ta)
    j_out = _np(JD.densify_and_prune(jp, ja, jadam, key, **KW,
                                     use_screen_size_prune=use_ss))
    t_out = TD.densify_and_prune(tp, ta, tadam, eps1, eps2, **KW,
                                 use_screen_size_prune=use_ss)
    return {'j': j_out, 't': t_out, 'before': before, 'inputs': inputs,
            'n_alive': n_alive,
            'use_ss': use_ss}


def test_alive_and_counts_match(case):
    (_, ja, _, jinfo), (_, ta, _, tinfo) = case['j'], case['t']
    assert np.array_equal(to_np(ta.alive), ja.alive)
    assert {k: int(v) for k, v in tinfo.items()} == \
        {k: int(v) for k, v in jinfo.items()}
    n = int(tinfo['n_alive'])
    assert to_np(ta.alive)[:n].all() and not to_np(ta.alive)[n:].any()
    assert int(tinfo['n_cloned']) > 0 and int(tinfo['n_split']) > 0
    assert int(tinfo['n_pruned']) > 0
    if case['n_alive'] == 1000:
        assert int(tinfo['n_dropped']) > 0
    else:
        assert int(tinfo['n_dropped']) == 0
    # the statistics and the neighbours are reset
    for f in ('max_radii2d', 'xyz_gradient_accum', 'denom', 'nn_ix'):
        assert not to_np(getattr(ta, f)).any(), f
    # the arguments are left as they were
    for arg, copy in zip(case['inputs'], case['before']):
        for f in arg.__dataclass_fields__:
            assert torch.equal(getattr(arg, f), getattr(copy, f)), f


def test_copied_rows_match_exactly_and_children_closely(case):
    (jp, _, _, _), (tp, _, _, _) = case['j'], case['t']
    for f in ('features_dc', 'features_rest', 'rotation', 'opacity'):
        assert np.array_equal(to_np(getattr(tp, f)), getattr(jp, f)), f
    for f in ('xyz', 'scaling'):
        got, want = to_np(getattr(tp, f)), getattr(jp, f)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f)
        # rows that are neither a child nor a clone are copies: exact
        same = (got == want).all(1)
        assert same.mean() > 0.8, f


def test_moments_zeroed_exactly(case):
    (_, _, jadam, _), (_, _, tadam, _) = case['j'], case['t']
    for f in FIELDS:
        for which in ('m', 'v'):
            got = to_np(getattr(getattr(tadam, which), f))
            want = getattr(getattr(jadam, which), f)
            assert np.array_equal(got, want), (which, f)
    zeroed = (to_np(tadam.m.xyz) == 0).all(1)
    assert zeroed.sum() >= int(case['t'][3]['n_cloned'])
    assert tadam.step == int(jadam.step) == 7


def test_reset_opacity_matches(case):
    (jp, ja, jadam, _), (tp, ta, tadam, _) = case['j'], case['t']
    jp2, jadam2 = _np(JD.reset_opacity(jax.tree.map(jnp.asarray, jp),
                                       jax.tree.map(jnp.asarray, jadam),
                                       jnp.asarray(ja.alive)))
    tp2, tadam2 = TD.reset_opacity(tp, tadam, ta.alive)
    np.testing.assert_allclose(to_np(tp2.opacity), jp2.opacity, rtol=0,
                               atol=1e-6)
    alive = to_np(ta.alive)
    assert (1 / (1 + np.exp(-to_np(tp2.opacity)[alive])) <= 0.01 + 1e-7).all()
    assert np.array_equal(to_np(tp2.opacity)[~alive],
                          to_np(tp.opacity)[~alive])
    for which in ('m', 'v'):
        assert not to_np(getattr(tadam2, which).opacity).any()
        assert np.array_equal(to_np(getattr(tadam2, which).xyz),
                              to_np(getattr(tadam, which).xyz))


def _sq_dists(xyz, nn_ix, rows):
    x = np.asarray(xyz, np.float64)
    return np.sort(((x[rows][:, None] - x[nn_ix[rows]]) ** 2).sum(-1), 1)


def test_refresh_knn_matches_by_distance(case):
    (jp, ja, _, jinfo), (tp, ta, _, _) = case['j'], case['t']
    bucket = 768 if case['n_alive'] == 700 else CAPACITY
    assert int(jinfo['n_alive']) <= bucket
    state = types.SimpleNamespace(gauss_params=tp,
                                  gauss_aux=ta.map(torch.clone))
    refresh_knn(state, bucket)
    t_ix = to_np(state.gauss_aux.nn_ix)
    j_ix = np.asarray(jknn.knn_self(jnp.asarray(jp.xyz[:bucket]),
                                    K_NEIGHBORS,
                                    mask=jnp.asarray(ja.alive[:bucket])))
    alive = np.flatnonzero(to_np(ta.alive))
    assert t_ix[alive].max() < int(jinfo['n_alive'])    # never a dead slot
    assert not t_ix[bucket:].any()
    xyz = to_np(tp.xyz)
    np.testing.assert_allclose(_sq_dists(xyz, t_ix, alive),
                               _sq_dists(xyz, j_ix, alive), rtol=0,
                               atol=1e-6)


def test_nn_index_matches_on_tie_free_points():
    rng = np.random.default_rng(11)
    q = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    p = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    want = np.asarray(jknn.nn_index(jnp.asarray(q), jnp.asarray(p)))
    got = tknn.nn_index(torch.from_numpy(q), torch.from_numpy(p))
    assert got.dtype == torch.int32
    assert np.array_equal(to_np(got), want)


def test_add_stats_matches():
    rng = np.random.default_rng(5)
    jp, ja, _ = _jax_arena(700, seed=5)
    g = rng.normal(size=(CAPACITY, 2)).astype(np.float32)
    radii = rng.integers(-1, 6, CAPACITY).astype(np.int32)
    want = _np(JD.add_stats(ja, jnp.asarray(g), jnp.asarray(radii)))
    _, ta = convert.arena(_np(jp), _np(ja))
    got = TD.add_stats(ta, torch.from_numpy(g), torch.from_numpy(radii))
    for f in ('max_radii2d', 'denom'):
        assert np.array_equal(to_np(getattr(got, f)), getattr(want, f)), f
    np.testing.assert_allclose(to_np(got.xyz_gradient_accum),
                               want.xyz_gradient_accum, rtol=1e-6, atol=0)
