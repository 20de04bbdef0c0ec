"""The model variants' modules of gsavatar_torch against gsavatar's, one by
one, on small random inputs drawn with numpy from seeds (CPU, f32).

Weights are random flax trees carried to the port through
gsavatar_torch.convert. Tolerances, unless a test says otherwise: rtol 1e-5
and atol 1e-6 on values (the two frameworks round elementwise operations
alike; matrix products sum in another order); gradients within 1e-5 of the
largest |value| of their leaf (a gradient sums over every point, in
another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.spatial.transform import Rotation

from torch_parity import close, random_conv_params, to_np

from gsavatar_torch import convert
from gsavatar_torch.camera.camera import make_camera as t_make_camera
from gsavatar_torch.config import load_config as t_load_config
from gsavatar_torch.core import gaussians as TG
from gsavatar_torch.models import embedders as temb
from gsavatar_torch.models import mlp as tmlp
from gsavatar_torch.models import non_rigid as tnr
from gsavatar_torch.models import pose_correction as tpc
from gsavatar_torch.models import rigid as trig
from gsavatar_torch.models import texture as ttex
from gsavatar_torch.ops import interp as tinterp
from gsavatar_torch.ops import knn as tknn
from gsavatar_torch.ops import sh as tsh
from gsavatar_torch.utils.aabb import AABB as TAABB

from gsavatar.camera.camera import make_camera as j_make_camera
from gsavatar.config.config import Config
from gsavatar.core import gaussians as JG
from gsavatar.models import embedders as jemb
from gsavatar.models import mlp as jmlp
from gsavatar.models import non_rigid as jnr
from gsavatar.models import pose_correction as jpc
from gsavatar.models import rigid as jrig
from gsavatar.models import texture as jtex
from gsavatar.ops import interp as jinterp
from gsavatar.ops import knn as jknn
from gsavatar.ops import sh as jsh
from gsavatar.utils.aabb import AABB as JAABB

RTOL, ATOL = 1e-5, 1e-6
N = 300
AABB_MAX = np.array([0.9, 1.1, 0.6], np.float32)
AABB_MIN = np.array([-0.8, -1.2, -0.5], np.float32)
# the deformer MLPs cut to small widths (64: the layer before the skip
# gives up the 39 encoded columns), the published skip and encoding
SMALL_NR = ["model.deformer.non_rigid.mlp.n_neurons=64",
            "model.deformer.non_rigid.mlp.n_hidden_layers=5"]


def grad_close(got, want, name=''):
    want = np.asarray(want)
    close(got, want, 0, 1e-5 * max(float(np.abs(want).max()), 1e-12), name)


def random_flax(module, *args, seed=0):
    """Random weights of a flax module at torch's default scale (kernels
    U(+-1/sqrt(fan_in)), biases U(+-0.1)), so that outputs are O(1)."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args))['params']
    return random_conv_params(shapes, {}, seed)


def arena(seed, use_sh=False, feature_dim=32):
    """Random Gaussians, a tenth of the slots dead."""
    rng = np.random.default_rng(seed)
    ch, rest = (3, 15) if use_sh else (1, feature_dim - 1)
    d = dict(xyz=rng.normal(scale=0.4, size=(N, 3)),
             features_dc=rng.normal(size=(N, 1, ch)),
             features_rest=rng.normal(scale=0.3, size=(N, rest, ch)),
             scaling=rng.uniform(-4, -2, (N, 3)),
             rotation=rng.normal(size=(N, 4)), opacity=rng.normal(size=(N, 1)))
    return ({k: v.astype(np.float32) for k, v in d.items()},
            rng.random(N) < 0.9)


def views(d, alive, deg=0, use_sh=False, **extra):
    """The same Gaussians as a JAX and a port view; `extra` numpy fields
    (fwd_transform, non_rigid_feature, rotation_precomp)."""
    jg = JG.Gaussians(
        params=JG.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()}),
        alive=jnp.asarray(alive), active_sh_degree=deg, use_sh=use_sh,
        **{k: jnp.asarray(v) for k, v in extra.items()})
    tg = TG.Gaussians(
        params=TG.GaussianParams(**{k: torch.from_numpy(v)
                                    for k, v in d.items()}),
        alive=torch.from_numpy(alive), active_sh_degree=deg, use_sh=use_sh,
        **{k: torch.from_numpy(v) for k, v in extra.items()})
    return jg, tg


def cameras(seed=0, latent_idx=1):
    rng = np.random.default_rng(seed)
    bt = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
    bt[:, :3, :3] = Rotation.random(24, random_state=seed + 1).as_matrix()
    bt[:, :3, 3] = rng.normal(scale=0.1, size=(24, 3))
    kw = dict(R=np.eye(3, dtype=np.float32),
              T=np.array([0.1, -0.2, 3.0], np.float32), fovx=0.8, fovy=0.8,
              rots=Rotation.random(24, random_state=seed).as_matrix()
              .reshape(1, 24, 9), Jtrs=rng.uniform(-0.8, 0.8, (1, 24, 3)),
              bone_transforms=bt, latent_idx=latent_idx)
    jc = j_make_camera(image=np.zeros((16, 16, 3)), mask=np.zeros((16, 16)),
                       **kw)
    return jc, t_make_camera(width=16, height=16, **kw)


def random_rotations(n, seed):
    return Rotation.random(n, random_state=seed).as_matrix().astype(
        np.float32)


# --- embedders ---------------------------------------------------------

@pytest.mark.parametrize('multires', [0, 6])
def test_embedder(multires):
    x = np.random.default_rng(1).uniform(-1.2, 1.2, (97, 3)).astype(
        np.float32)
    j_fn, j_dim = jemb.get_embedder(multires, 3)
    t_fn, t_dim = temb.get_embedder(multires, 3)
    assert t_dim == j_dim
    close(t_fn(torch.from_numpy(x)), j_fn(jnp.asarray(x)), RTOL, ATOL)


@pytest.mark.parametrize('iteration', [0, 3000, 6000, 10000, 20000])
def test_hannw_weights_and_embedder(iteration):
    """Zero before kick-in (3000), ramped frequency by frequency to the
    full band (10000); the embedder's columns scaled by them."""
    w_t = temb.hannw_weights(iteration, 6, 3000, 10000)
    w_j = jemb.hannw_weights(iteration, 6, 3000, 10000)
    close(w_t, w_j, RTOL, 1e-7)
    if iteration <= 3000:
        assert not w_t.any()
    if iteration >= 10000:
        assert (w_t == 1).all()
    if iteration == 6000:
        # alpha = 6 * 3000 / 7000: two bands full, one partial
        assert ((0 < w_t) & (w_t < 1)).sum() == 1
    x = np.random.default_rng(2).uniform(-1, 1, (50, 3)).astype(np.float32)
    j_fn, j_dim = jemb.get_hannw_embedder(6, 3000, 10000)
    t_fn, t_dim = temb.get_hannw_embedder(6, 3000, 10000)
    assert t_dim == j_dim == 36
    close(t_fn(torch.from_numpy(x), iteration), j_fn(jnp.asarray(x),
                                                     iteration), RTOL, ATOL)
    # a window that never anneals is the full band at once
    close(temb.hannw_weights(0, 6, 5000, 5000),
          jemb.hannw_weights(0, 6, 5000, 5000), 0, 0)


# --- MLPs --------------------------------------------------------------

def test_vanilla_cond_mlp_multires_skip():
    """multires 6 and skip [4]: the skip concat takes the encoded input;
    the flax tree (last layer a bare Dense named lin{l}) loads strictly."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (41, 3)).astype(np.float32)
    cond = rng.normal(size=(1, 5)).astype(np.float32)
    kw = dict(dim_in=3, dim_cond=5, dim_out=12, n_neurons=64,
              n_hidden_layers=5, skip_in=(4,), cond_in=(0,), multires=6,
              last_layer_init=True)
    jm = jmlp.VanillaCondMLP(**kw)
    params = random_flax(jm, jnp.asarray(x), jnp.asarray(cond))
    want = jm.apply({'params': params}, jnp.asarray(x), jnp.asarray(cond))
    tm = tmlp.VanillaCondMLP(**kw)
    tm.load_state_dict(convert.converter_state(params))
    close(tm(torch.from_numpy(x), torch.from_numpy(cond)), want, RTOL, ATOL)
    # the layer before the skip gives up the 39 encoded columns it takes
    assert tm.lin3.weight.shape[0] == 64 - 39
    assert tm.lin4.weight.shape[1] == 64


def test_last_layer_init():
    """N(0, 1e-5) kernel and zero bias on the last layer, in both."""
    kw = dict(dim_in=3, dim_cond=0, dim_out=10, n_neurons=32,
              n_hidden_layers=3, multires=6, last_layer_init=True)
    x = jnp.zeros((4, 3))
    jp = jmlp.VanillaCondMLP(**kw).init(jax.random.PRNGKey(1), x)['params']
    tm = tmlp.VanillaCondMLP(**kw, generator=torch.Generator().manual_seed(1))
    for w, b in ((np.asarray(jp['lin3']['kernel']),
                  np.asarray(jp['lin3']['bias'])),
                 (to_np(tm.lin3.weight), to_np(tm.lin3.bias))):
        assert not b.any()
        assert 2e-6 < w.std() < 5e-5
    assert to_np(tm.lin0.weight).std() > 1e-2
    tm.load_state_dict(convert.converter_state(jax.tree.map(np.asarray, jp)))


@pytest.mark.parametrize('iteration', [3000, 6500, 10000])
def test_hannw_cond_mlp(iteration):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (33, 3)).astype(np.float32)
    cond = rng.normal(size=(1, 7)).astype(np.float32)
    kw = dict(dim_in=3, dim_cond=7, dim_out=10, n_neurons=64,
              n_hidden_layers=5, kick_in_iter=3000, full_band_iter=10000,
              skip_in=(4,), cond_in=(0,), multires=6)
    jm = jmlp.HannwCondMLP(**kw)
    params = random_flax(jm, jnp.asarray(x), iteration, jnp.asarray(cond))
    want = jm.apply({'params': params}, jnp.asarray(x), iteration,
                    jnp.asarray(cond))
    tm = tmlp.HannwCondMLP(**kw)
    tm.load_state_dict(convert.converter_state(params))
    close(tm(torch.from_numpy(x), iteration, torch.from_numpy(cond)), want,
          RTOL, ATOL)


def test_hannw_cond_mlp_init():
    """Every bias zero, the condition's columns of each cond_in layer zero
    (the JAX kernel's last rows), in both packages."""
    kw = dict(dim_in=3, dim_cond=7, dim_out=10, n_neurons=64,
              n_hidden_layers=4, kick_in_iter=3000, full_band_iter=10000,
              skip_in=(3,), cond_in=(0, 2), multires=6)
    jp = jmlp.HannwCondMLP(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), 0, jnp.zeros((1, 7)))
    jstate = convert.converter_state(jax.tree.map(np.asarray, jp['params']))
    tm = tmlp.HannwCondMLP(**kw, generator=torch.Generator().manual_seed(0))
    tstate = tm.state_dict()
    assert set(jstate) == set(tstate)
    for name, state in (('jax', jstate), ('port', tstate)):
        for l in range(5):
            w, b = state[f'lin{l}.weight'], state[f'lin{l}.bias']
            assert not b.any(), (name, l)
            if l in (0, 2):
                assert not w[:, -7:].any(), (name, l)
                assert w[:, :-7].any(), (name, l)
            assert tuple(w.shape) == tuple(jstate[f'lin{l}.weight'].shape)


# --- offsets -----------------------------------------------------------

MODES = [(s, r) for s in ('logit', 'exp', 'zero') for r in ('add', 'mult')]


@pytest.mark.parametrize('scale_offset,rot_offset', MODES)
def test_apply_deltas(scale_offset, rot_offset):
    """Values and gradients of every offset mode pair, gate open; the
    closed gate is the identity."""
    d, alive = arena(5)
    rng = np.random.default_rng(6)
    deltas = [rng.normal(scale=0.05, size=(N, k)).astype(np.float32)
              for k in (3, 3, 4)]
    # the regularized rotation delta: the three vector parts under 'mult'
    reg_rot = 3 if rot_offset == 'mult' else 4
    cts = [rng.normal(size=s).astype(np.float32)
           for s in ((N, 3), (N, 3), (N, 4), (N, 3), (N, 3), (N, reg_rot))]

    def j_fn(xyz, scaling, rotation, dx, ds, dr):
        p = {**{k: jnp.asarray(v) for k, v in d.items()}, 'xyz': xyz,
             'scaling': scaling, 'rotation': rotation}
        jg = JG.Gaussians(params=JG.GaussianParams(**p),
                          alive=jnp.asarray(alive))
        out, a, b, c = jnr._apply_deltas(jg, dx, ds, dr, scale_offset,
                                         rot_offset, 1.0)
        return (out.params.xyz, out.params.scaling, out.params.rotation,
                a, b, c)

    args = [d['xyz'], d['scaling'], d['rotation']] + deltas
    want, vjp = jax.vjp(j_fn, *[jnp.asarray(a) for a in args])
    want_g = vjp(tuple(jnp.asarray(c) for c in cts))

    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    p = {**{k: torch.from_numpy(v) for k, v in d.items()},
         'xyz': targs[0], 'scaling': targs[1], 'rotation': targs[2]}
    tg = TG.Gaussians(params=TG.GaussianParams(**p),
                      alive=torch.from_numpy(alive))
    out, a, b, c = tnr._apply_deltas(tg, *targs[3:], scale_offset,
                                     rot_offset, 1.0)
    got = (out.params.xyz, out.params.scaling, out.params.rotation, a, b, c)
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, RTOL, ATOL, f'output {i}')
    # the 'zero' scale mode's delta is a constant
    live = [(g, torch.from_numpy(c)) for g, c in zip(got, cts)
            if g.requires_grad]
    got_g = torch.autograd.grad([g for g, _ in live], targs,
                                [c for _, c in live], allow_unused=True)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        g = torch.zeros_like(targs[i]) if g is None else g
        grad_close(g, w, f'gradient {i}')
    closed, *_ = tnr._apply_deltas(tg, *targs[3:], scale_offset, rot_offset,
                                   0.0)
    for f in ('xyz', 'scaling', 'rotation'):
        want_f = getattr(tg.params, f)
        if f == 'rotation' and rot_offset == 'mult':
            want_f = tnr.T.quat_multiply(
                torch.tensor([[1.0, 0, 0, 0]]).expand(N, 4), want_f)
        close(getattr(closed.params, f), want_f, 1e-6, 1e-6, f)


# --- grid sampling and SH ----------------------------------------------

def test_grid_sample_3d():
    """Coordinates inside and outside [-1, 1] (border clamping): values
    and gradients against the JAX function; values also against
    F.grid_sample(padding_mode='border', align_corners=False), a second
    check that the port never calls."""
    rng = np.random.default_rng(7)
    vol = rng.normal(size=(5, 4, 6, 7)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (200, 3)).astype(np.float32)
    assert (np.abs(coords) > 1).any(axis=1).mean() > 0.3
    ct = rng.normal(size=(200, 5)).astype(np.float32)
    want, vjp = jax.vjp(jinterp.grid_sample_3d, jnp.asarray(vol),
                        jnp.asarray(coords))
    want_gv, want_gc = vjp(jnp.asarray(ct))
    tv = torch.from_numpy(vol).requires_grad_()
    tc = torch.from_numpy(coords).requires_grad_()
    got = tinterp.grid_sample_3d(tv, tc)
    close(got, want, RTOL, ATOL)
    gv, gc = torch.autograd.grad(got, (tv, tc), torch.from_numpy(ct))
    grad_close(gv, want_gv, 'volume')
    grad_close(gc, want_gc, 'coordinates')
    lib = F.grid_sample(torch.from_numpy(vol)[None],
                        torch.from_numpy(coords)[None, :, None, None],
                        mode='bilinear', padding_mode='border',
                        align_corners=False)[0, :, :, 0, 0].T
    close(lib, want, 1e-5, 1e-5)


@pytest.mark.parametrize('deg', [0, 1, 2, 3])
def test_eval_sh(deg):
    """Values, and gradients: zero for the coefficients above the active
    degree in both."""
    rng = np.random.default_rng(8)
    shs = rng.normal(size=(64, 3, 16)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ct = rng.normal(size=(64, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda s: jsh.eval_sh(deg, s, jnp.asarray(dirs)),
                        jnp.asarray(shs))
    (want_g,) = vjp(jnp.asarray(ct))
    t = torch.from_numpy(shs).requires_grad_()
    got = tsh.eval_sh(deg, t, torch.from_numpy(dirs))
    close(got, want, RTOL, ATOL)
    (g,) = torch.autograd.grad(got, t, torch.from_numpy(ct))
    grad_close(g, want_g)
    n = (deg + 1) ** 2
    assert not to_np(g)[..., n:].any()
    assert not np.asarray(want_g)[..., n:].any()
    assert to_np(g)[..., :n].any()
    close(tsh.sh_to_rgb(torch.from_numpy(shs)), jsh.sh_to_rgb(
        jnp.asarray(shs)), RTOL, ATOL)


# --- non-rigid variants ------------------------------------------------

def nr_metadata():
    return ({'aabb': JAABB(AABB_MAX, AABB_MIN), 'frame_dict': {0: 0, 1: 1}},
            {'aabb': TAABB(AABB_MAX, AABB_MIN), 'frame_dict': {0: 0, 1: 1}})


def non_rigid_pair(overrides, seed=0):
    cfg = t_load_config(overrides)['model']['deformer']['non_rigid']
    jmd, tmd = nr_metadata()
    jm = jnr.get_non_rigid(Config(cfg), jmd)
    tm = tnr.get_non_rigid(cfg, tmd)
    return cfg, jm, tm


NR_CASES = {
    'mlp': ['non_rigid=mlp'] + SMALL_NR,
    'mlp_latent_exp_add': ['non_rigid=mlp', 'texture=sh'] + SMALL_NR + [
        'model.deformer.non_rigid.latent_dim=4',
        'model.deformer.non_rigid.scale_offset=exp',
        'model.deformer.non_rigid.rot_offset=add',
        'model.deformer.non_rigid.mlp.last_layer_init=true'],
    'hannw_mlp': ['non_rigid=hannw_mlp'] + SMALL_NR,
}


@pytest.mark.parametrize('case', sorted(NR_CASES))
@pytest.mark.parametrize('iteration', [2000, 6500, 15000])
def test_non_rigid_variants(case, iteration):
    """The MLP and Hann-window deformers before their gates (delay and
    kick-in at 3000: deltas zero), inside the Hann window and past it:
    positions, scales, rotations, the non-rigid feature and the
    regularizers."""
    cfg, jm, tm = non_rigid_pair(NR_CASES[case])
    d, alive = arena(9)
    jg, tg = views(d, alive)
    jc, tc = cameras(1)
    params = random_flax(jm, jg, jc, iteration, jc.latent_idx, seed=3)
    j_out, j_reg = jm.apply({'params': params}, jg, jc, iteration,
                            jc.latent_idx)
    tm.load_state_dict(convert.converter_state(params))
    t_out, t_reg = tm(tg, tc, iteration, tc.latent_idx)
    for f in ('xyz', 'scaling', 'rotation'):
        close(getattr(t_out.params, f), getattr(j_out.params, f), RTOL, ATOL,
              f)
    if j_out.non_rigid_feature is None:
        assert t_out.non_rigid_feature is None
    else:
        close(t_out.non_rigid_feature, j_out.non_rigid_feature, RTOL, ATOL)
    assert set(t_reg) == set(j_reg)
    for k in j_reg:
        close(t_reg[k], j_reg[k], RTOL, 1e-7, k)
    moved = float((t_out.params.xyz - tg.params.xyz).detach().abs().max())
    assert (moved > 0) == (iteration >= 3000), moved


@pytest.mark.parametrize('feature_dim', [0, 8])
def test_identity_non_rigid(feature_dim):
    jmd, tmd = nr_metadata()
    cfg = {'name': 'identity', 'delay': 0, 'feature_dim': feature_dim}
    jm = jnr.get_non_rigid(Config(cfg), jmd)
    tm = tnr.get_non_rigid(cfg, tmd)
    d, alive = arena(10)
    jg, tg = views(d, alive)
    jc, tc = cameras(2)
    j_out, j_reg = jm.apply({}, jg, jc, 15000, jc.latent_idx)
    t_out, t_reg = tm(tg, tc, 15000, tc.latent_idx)
    assert t_reg == j_reg == {}
    assert t_out.params is tg.params
    if feature_dim:
        close(t_out.non_rigid_feature, j_out.non_rigid_feature, 0, 0)
        assert t_out.non_rigid_feature.shape == (N, feature_dim)
    else:
        assert t_out.non_rigid_feature is j_out.non_rigid_feature is None
    assert list(tm.parameters()) == []


# --- rigid variants ----------------------------------------------------

def rigid_out_close(t_out, j_out):
    close(t_out.get_xyz, j_out.get_xyz, RTOL, ATOL, 'xyz')
    close(t_out.rotation_precomp, j_out.rotation_precomp, RTOL, ATOL,
          'rotation_precomp')
    close(t_out.fwd_transform, j_out.fwd_transform, RTOL, ATOL,
          'fwd_transform')


def test_identity_rigid():
    jc, tc = cameras(3)
    d, alive = arena(11)
    jg, tg = views(d, alive)
    j_out = jrig.get_rigid(Config({'name': 'identity'}), {}).apply(
        {}, jg, jc, 0)
    t_out = trig.get_rigid({'name': 'identity'}, {})(tg, tc, 0)
    assert t_out is tg and j_out is jg
    assert t_out.fwd_transform is None and t_out.rotation_precomp is None


def test_smpl_nn():
    """Nearest template vertex: the same indices as the JAX package (the
    queries keep a margin from every tie), the same LBS, and the
    gradient of the skinning weights through the gather."""
    rng = np.random.default_rng(12)
    verts = rng.normal(scale=0.5, size=(400, 3)).astype(np.float32)
    weights = rng.dirichlet(np.ones(24) * 0.3, 400).astype(np.float32)
    d, alive = arena(13)
    jc, tc = cameras(4)
    jm = jrig.get_rigid(Config({'name': 'smpl_nn'}),
                        {'smpl_verts': verts, 'skinning_weights': weights})
    tm = trig.get_rigid({'name': 'smpl_nn'},
                        {'smpl_verts': verts, 'skinning_weights': weights})
    idx_j = np.asarray(jknn.nn_index(jnp.asarray(d['xyz']),
                                     jnp.asarray(verts)))
    idx_t = to_np(tknn.nn_index(torch.from_numpy(d['xyz']),
                                torch.from_numpy(verts)))
    np.testing.assert_array_equal(idx_t, idx_j)
    jg, tg = views(d, alive)
    j_out = jm.apply({}, jg, jc, 0)
    t_out = tm(tg, tc, 0)
    rigid_out_close(t_out, j_out)
    ct = rng.normal(size=(N, 3)).astype(np.float32)

    def j_fn(w):
        m = jrig.SMPLNN(smpl_verts=jnp.asarray(verts), skinning_weights=w)
        return m.apply({}, jg, jc, 0).get_xyz

    _, vjp = jax.vjp(j_fn, jnp.asarray(weights))
    (want,) = vjp(jnp.asarray(ct))
    tm.skinning_weights.requires_grad_(True)
    (got,) = torch.autograd.grad(tm(tg, tc, 0).get_xyz, tm.skinning_weights,
                                 torch.from_numpy(ct))
    grad_close(got, want)
    assert to_np(got).any()


def distill_pair(res=16):
    cfg = t_load_config([
        'model.deformer.rigid.distill=true', f'model.deformer.rigid.res={res}',
        'model.deformer.rigid.skinning_network.n_neurons=32',
        'model.deformer.rigid.skinning_network.n_hidden_layers=2'])[
        'model']['deformer']['rigid']
    jm = jrig.get_rigid(Config(cfg), {'aabb': JAABB(AABB_MAX, AABB_MIN)})
    tm = trig.get_rigid(cfg, {'aabb': TAABB(AABB_MAX, AABB_MIN)})
    return jm, tm


def test_distilled_skinning_field():
    """The (res / 4, res, res) voxel of the field, sampled: LBS outputs,
    the skinning loss, and the gradient of the MLP's weights through the
    voxel."""
    jm, tm = distill_pair()
    d, alive = arena(14)
    jg, tg = views(d, alive)
    jc, tc = cameras(5)
    params = random_flax(jm, jg, jc, 0, seed=5)
    tm.load_state_dict(convert.converter_state(params))
    rigid_out_close(tm(tg, tc, 0), jm.apply({'params': params}, jg, jc, 0))
    rng = np.random.default_rng(15)
    pts = rng.uniform(-1.1, 1.1, (128, 3)).astype(np.float32)
    gt = rng.dirichlet(np.ones(24), 128).astype(np.float32)

    def j_loss(p):
        return jm.apply({'params': p}, jnp.asarray(pts), jnp.asarray(gt),
                        method=jm.skinning_loss)

    want, want_g = jax.value_and_grad(j_loss)(params)
    got = tm.skinning_loss(torch.from_numpy(pts), torch.from_numpy(gt))
    close(got, want, RTOL, 1e-7)
    names = dict(tm.named_parameters())
    grads = torch.autograd.grad(got, list(names.values()))
    want_named = convert.converter_state(jax.tree.map(np.asarray, want_g))
    for (k, _), g in zip(names.items(), grads):
        grad_close(g, want_named[k], k)
    assert tm._voxel().shape == (24, 4, 16, 16)


# --- texture and pose-correction variants -------------------------------

@pytest.mark.parametrize('deg', [0, 3])
@pytest.mark.parametrize('noise', [False, True])
def test_sh2rgb(deg, noise):
    """SH colours at the canonical view direction (a random rigid
    transform), with the view-noise rotation, at active degree 0 and 3;
    both texture names."""
    d, alive = arena(16, use_sh=True)
    fwd = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    fwd[:, :3, :3] = random_rotations(N, 17)
    jg, tg = views(d, alive, deg=deg, use_sh=True, fwd_transform=fwd)
    jc, tc = cameras(6)
    rot = random_rotations(1, 18)[0] if noise else None
    for name in ('sh2rgb', 'sh'):
        cfg = {'name': name, 'cano_view_dir': True}
        want = jtex.get_texture(Config(cfg), {}).apply(
            {}, jg, jc, None, view_noise_rot=None if rot is None
            else jnp.asarray(rot))
        got = ttex.get_texture(cfg, {})(
            tg, tc, None, view_noise_rot=None if rot is None
            else torch.from_numpy(rot))
        close(got, want, RTOL, ATOL, name)
    assert float(got.min()) >= 0


def test_color_mlp_optional_inputs():
    """ColorMLP with the position, covariance and quasi-normal inputs that
    no yaml sets, at the wide texture's feature and latent widths."""
    cfg = t_load_config(['texture=mlp', 'model.texture.use_xyz=true',
                         'model.texture.use_cov=true',
                         'model.texture.use_normal=true',
                         'model.texture.mlp.n_neurons=32',
                         'model.texture.mlp.n_hidden_layers=2'])[
        'model']['texture']
    md_j = {'aabb': JAABB(AABB_MAX, AABB_MIN), 'frame_dict': {0: 0, 1: 1}}
    md_t = {'aabb': TAABB(AABB_MAX, AABB_MIN), 'frame_dict': {0: 0, 1: 1}}
    jm, tm = jtex.get_texture(Config(cfg), md_j), ttex.get_texture(cfg, md_t)
    d, alive = arena(19, feature_dim=128)
    rng = np.random.default_rng(20)
    fwd = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    fwd[:, :3, :3] = random_rotations(N, 21)
    feat = rng.normal(size=(N, 64)).astype(np.float32)
    jg, tg = views(d, alive, fwd_transform=fwd, non_rigid_feature=feat)
    jc, tc = cameras(7)
    params = random_flax(jm, jg, jc, jc.latent_idx, seed=6)
    want = jm.apply({'params': params}, jg, jc, jc.latent_idx)
    tm.load_state_dict(convert.converter_state(params))
    close(tm(tg, tc, tc.latent_idx), want, RTOL, ATOL)
    assert tm.mlp.lin0.weight.shape[1] == 128 + 3 + 6 + 3 + 15 + 64 + 64


def test_no_pose_correction():
    jc, tc = cameras(8)
    j_cam, j_reg = jpc.get_pose_correction(Config({'name': 'none'}), {}) \
        .apply({}, jc, 15000)
    t_cam, t_reg = tpc.get_pose_correction({'name': 'none'}, {}, None)(
        tc, 15000)
    assert t_cam is tc and j_cam is jc and t_reg == j_reg == {}


@pytest.mark.parametrize('non_rigid', ['identity', 'hannw_mlp'])
def test_featureless_deformer_under_shallow_mlp_raises(non_rigid):
    """The identity deformer (no feature_dim in its yaml) and the
    Hann-window deformer give no non-rigid feature, and the default texture
    takes 16 columns of one: the JAX package fails its assertion
    (gsavatar/models/texture.py:91), the port raises a ValueError that
    names the pairing. Under texture=sh the pair builds."""
    ov = [f'non_rigid={non_rigid}'] + SMALL_NR
    cfg = t_load_config(ov)
    nr_cfg = cfg['model']['deformer']['non_rigid']
    tex_cfg = cfg['model']['texture']
    assert tex_cfg['non_rigid_dim'] == 16
    jmd, tmd = nr_metadata()
    jnm, tnm = jnr.get_non_rigid(Config(nr_cfg), jmd), \
        tnr.get_non_rigid(nr_cfg, tmd)
    d, alive = arena(22)
    jg, tg = views(d, alive)
    jc, tc = cameras(9)
    jp = {'params': random_flax(jnm, jg, jc, 15000, jc.latent_idx)} \
        if non_rigid != 'identity' else {}
    j_out, _ = jnm.apply(jp, jg, jc, 15000, jc.latent_idx)
    if jp:
        tnm.load_state_dict(convert.converter_state(jp['params']))
    t_out, _ = tnm(tg, tc, 15000, tc.latent_idx)
    assert j_out.non_rigid_feature is None and t_out.non_rigid_feature is None
    jtx = jtex.get_texture(Config(tex_cfg), jmd)
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda: jtx.init(jax.random.PRNGKey(0), j_out, jc,
                                        jc.latent_idx))
    with pytest.raises(ValueError, match='non-rigid feature'):
        ttex.get_texture(tex_cfg, tmd)(t_out, tc, tc.latent_idx)
    sh_cfg = t_load_config(ov + ['texture=sh'])['model']['texture']
    assert ttex.get_texture(sh_cfg, tmd)(
        t_out.replace(params=t_out.params.replace(
            features_dc=torch.zeros(N, 1, 3),
            features_rest=torch.zeros(N, 15, 3))), tc).shape == (N, 3)


def test_distilled_voxel_built_once_per_step(monkeypatch):
    """A training step of the distilled field builds its voxel once: the
    rigid deformer's forward builds it and the step's skinning loss samples
    the same one (the JAX step's two identical builds, which XLA merges).
    The next step, after the optimizer moved the MLP, builds a new one; a
    skinning loss after such a move never samples the old one."""
    from torch_parity import TINY
    from gsavatar_torch.scene import Scene
    from gsavatar_torch.train import loss_weights, make_train_step
    cfg = t_load_config(TINY + [
        'model.deformer.rigid.distill=true', 'model.deformer.rigid.res=16',
        'dataset.n_target_gaussians=512', 'opt.skinning_pool_size=2048',
        'opt.n_reg_pts=128'])
    scene = Scene(cfg, device='cpu')
    state = scene.init_state()
    field = scene.converter.rigid
    builds = []
    build = trig.SkinningField._voxel
    monkeypatch.setattr(trig.SkinningField, '_voxel',
                        lambda self: builds.append(1) or build(self))
    step = make_train_step(scene)
    w = dict(loss_weights(cfg, 12000), _in_densify_window=1.0)
    for i in range(2):
        state, m = step(state, scene.train_dataset[0], 12000 + i, w, 1e-4)
        assert len(builds) == i + 1
        assert float(m['loss/loss_skinning']) > 0
    pts = scene.skinning_pool_pts[:64]
    gt = scene.skinning_pool_w[:64]
    with torch.no_grad():
        for p in field.lbs_network.parameters():
            p.mul_(0.5)
        kept = field.skinning_loss(pts, gt)
    assert len(builds) == 3
    with torch.no_grad():
        fresh = (tinterp.grid_sample_3d(build(field), pts) - gt).pow(
            2).sum(-1).mean()
    assert torch.equal(kept, fresh)
