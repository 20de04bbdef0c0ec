"""gsavatar_torch's model stack against gsavatar's, module by module and as
the whole converter at eval, on the tiny synthetic avatar (CPU, f32).

Inputs and weights are drawn with numpy from seeds; the JAX flax trees go
to the port through gsavatar_torch.convert. Tolerances: 1e-6 relative for
the elementwise and gather modules (the two frameworks round alike; only
the summation order of a few terms differs), 1e-5 where matrix products
and the 24-joint pose encoder chain reorder sums of 100+ terms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import ITERATION, JaxAvatar, TorchAvatar, close, to_np

from gsavatar_torch import convert
from gsavatar_torch.core import gaussians as TG
from gsavatar_torch.models import mlp as tmlp
from gsavatar_torch.models.converter import build_converter, compute_nr_cache
from gsavatar_torch.models.hashgrid import HashGrid as THashGrid
from gsavatar_torch.models.rigid import hierarchical_softmax as t_hsoftmax
from gsavatar_torch.utils.transforms import quat_to_rotmat

from gsavatar.models import mlp as jmlp
from gsavatar.models.hashgrid import HashGrid as JHashGrid
from gsavatar.models.rigid import hierarchical_softmax as j_hsoftmax


@pytest.fixture(scope='module')
def avatars():
    ja = JaxAvatar()
    ta = TorchAvatar(ja)
    conv = build_converter(ta.cfg, ta.train.metadata, ta.train.assets)
    conv.load_state_dict(ta.state.converter)
    return ja, ta, conv.eval()


def _random_flax(module, *args, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args))['params']
    return jax.tree.map(
        lambda s: rng.uniform(-0.5, 0.5, s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize('kw', [
    dict(skip_in=(2,), cond_in=(0, 2)),
    dict(cond_in=(0,)),
], ids=['skip_cond', 'cond_first'])
def test_vanilla_cond_mlp(kw):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(37, 5)).astype(np.float32)
    cond = rng.normal(size=(1, 3)).astype(np.float32)
    jm = jmlp.VanillaCondMLP(dim_in=5, dim_cond=3, dim_out=4, n_neurons=16,
                             n_hidden_layers=3, **kw)
    params = _random_flax(jm, jnp.asarray(x), jnp.asarray(cond))
    want = jm.apply({'params': params}, jnp.asarray(x), jnp.asarray(cond))
    tm = tmlp.VanillaCondMLP(dim_in=5, dim_cond=3, dim_out=4, n_neurons=16,
                             n_hidden_layers=3, **kw)
    tm.load_state_dict(convert.converter_state(params))
    got = tm(torch.from_numpy(x), torch.from_numpy(cond))
    close(got, want, rtol=1e-5, atol=1e-6)


def test_hashgrid_forward_rounds_table_to_bf16():
    """Hashed and dense levels, points a little outside [-1, 1] (negative
    corners wrap as uint32), bf16 table reads. Tolerance 1e-6 of the table
    scale: a port that read the f32 table would be off by ~1e-4."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.05, 1.05, (257, 3)).astype(np.float32)
    jm = JHashGrid(n_levels=6, log2_hashmap_size=12, base_resolution=4,
                   max_resolution=256)
    table = rng.uniform(-0.05, 0.05, (6, 1 << 12, 2)).astype(np.float32)
    want = np.asarray(jm.apply({'params': {'table': jnp.asarray(table)}},
                               jnp.asarray(x)))
    tm = THashGrid(n_levels=6, log2_hashmap_size=12, base_resolution=4,
                   max_resolution=256)
    assert tm.resolutions == jm._resolutions()
    assert any((r + 1) ** 3 <= 1 << 12 for r in tm.resolutions)
    assert any((r + 1) ** 3 > 1 << 12 for r in tm.resolutions)
    tm.load_state_dict({'table': torch.from_numpy(table)})
    got = tm(torch.from_numpy(x)).detach().numpy()
    close(got, want, rtol=1e-6, atol=5e-8)
    # the rounding moves table entries by far more than the tolerance
    t = torch.from_numpy(table)
    assert (t - t.to(torch.bfloat16).float()).abs().max() > 1e-5


def test_nr_cache(avatars):
    ja, ta, conv = avatars
    got = compute_nr_cache(conv, ta.gview)
    close(got, ja.nr_cache, rtol=1e-6, atol=5e-8)


def test_hashgrid_non_rigid_with_cache(avatars):
    ja, ta, conv = avatars
    cache = np.asarray(ja.nr_cache)
    nr = ja.converter.non_rigid
    j_out, j_reg = jax.jit(lambda p, g, c, nc: nr.apply(
        {'params': p}, g, c, ITERATION, c.latent_idx, nr_cache=nc))(
        ja.variables['params']['non_rigid'], ja.gview, ja.camera,
        jnp.asarray(cache))
    t_out, t_reg = conv.non_rigid(ta.gview, ta.camera, ITERATION,
                                  ta.camera.latent_idx,
                                  nr_cache=torch.from_numpy(cache))
    for f in ('xyz', 'scaling', 'rotation'):
        close(getattr(t_out.params, f), getattr(j_out.params, f),
              rtol=1e-5, atol=1e-6, name=f)
    close(t_out.non_rigid_feature, j_out.non_rigid_feature, rtol=1e-5,
          atol=1e-6)
    for k in j_reg:
        close(t_reg[k], j_reg[k], rtol=1e-5, atol=1e-7, name=k)


def test_hierarchical_softmax():
    x = np.random.default_rng(3).normal(scale=3.0, size=(64, 25)).astype(
        np.float32)
    want = j_hsoftmax(jnp.asarray(x))
    got = t_hsoftmax(torch.from_numpy(x))
    close(got, want, rtol=1e-6, atol=1e-7)
    close(got.sum(1), np.ones(64), rtol=1e-5, atol=0)


def test_skinning_field(avatars):
    ja, ta, conv = avatars
    rig = ja.converter.rigid
    j_out = jax.jit(lambda p, g, c: rig.apply({'params': p}, g, c,
                                              ITERATION))(
        ja.variables['params']['rigid'], ja.gview, ja.camera)
    t_out = conv.rigid(ta.gview, ta.camera, ITERATION)
    close(t_out.get_xyz, j_out.get_xyz, rtol=1e-5, atol=1e-6, name='xyz')
    close(t_out.rotation_precomp, j_out.rotation_precomp, rtol=1e-5,
          atol=1e-6, name='rotation_precomp')
    close(t_out.fwd_transform, j_out.fwd_transform, rtol=1e-5, atol=1e-6,
          name='fwd_transform')


def test_color_mlp(avatars):
    """Texture on Gaussians with a random rigid transform and non-rigid
    feature, so that the canonical view directions are exercised."""
    ja, ta, conv = avatars
    rng = np.random.default_rng(4)
    n = ja.gview.params.xyz.shape[0]
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    fwd = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    fwd[:, :3, :3] = to_np(quat_to_rotmat(torch.from_numpy(q)))
    feat = rng.normal(size=(n, 16)).astype(np.float32)
    dc = rng.normal(size=(n, 1, 1)).astype(np.float32)
    rest = rng.normal(size=(n, 31, 1)).astype(np.float32)
    jg = ja.gview.replace(
        params=ja.gview.params.replace(features_dc=jnp.asarray(dc),
                                       features_rest=jnp.asarray(rest)),
        fwd_transform=jnp.asarray(fwd), non_rigid_feature=jnp.asarray(feat))
    tex = ja.converter.texture
    want = jax.jit(lambda p, g, c: tex.apply({'params': p}, g, c,
                                             c.latent_idx))(
        ja.variables['params']['texture'], jg, ja.camera)
    tg = ta.gview.replace(
        params=ta.gview.params.replace(features_dc=torch.from_numpy(dc),
                                       features_rest=torch.from_numpy(rest)),
        fwd_transform=torch.from_numpy(fwd),
        non_rigid_feature=torch.from_numpy(feat))
    got = conv.texture(tg, ta.camera, ta.camera.latent_idx)
    close(got, want, rtol=1e-5, atol=1e-6)


def test_direct_pose_optimization(avatars):
    ja, ta, conv = avatars
    pc = ja.converter.pose_correction
    j_cam, j_loss = jax.jit(lambda p, c: pc.apply({'params': p}, c,
                                                  ITERATION))(
        ja.variables['params']['pose_correction'], ja.camera)
    t_cam, t_loss = conv.pose_correction(ta.camera, ITERATION)
    for f in ('rots', 'Jtrs', 'bone_transforms'):
        close(getattr(t_cam, f), getattr(j_cam, f), rtol=1e-5, atol=1e-6,
              name=f)
    close(t_loss['pose'], j_loss['pose'], rtol=1e-5, atol=1e-9)
    # before the delay the camera passes through unchanged
    t_cam0, _ = conv.pose_correction(ta.camera, 0)
    assert torch.equal(t_cam0.bone_transforms, ta.camera.bone_transforms)


def test_converter_at_eval(avatars):
    """The whole stack, GaussianConverter.apply with the cache against the
    port's converter: positions, covariances, opacities, colours and the
    regularization terms."""
    ja, ta, conv = avatars

    def jax_fwd(v, g, c, nc):
        d, reg, col = ja.converter.apply(v, g, c, ITERATION, nr_cache=nc)
        return d.get_xyz, d.get_covariance(), d.get_opacity, col, reg

    j_xyz, j_cov, j_op, j_col, j_reg = jax.jit(jax_fwd)(
        ja.variables, ja.gview, ja.camera, ja.nr_cache)
    with torch.no_grad():
        d, t_reg, t_col = conv(ta.gview, ta.camera, ITERATION,
                               nr_cache=compute_nr_cache(conv, ta.gview))
    alive = to_np(ta.gview.alive)
    for name, got, want in (('xyz', d.get_xyz, j_xyz),
                            ('cov', d.get_covariance(), j_cov),
                            ('opacity', d.get_opacity, j_op),
                            ('colors', t_col, j_col)):
        close(to_np(got)[alive], to_np(want)[alive], rtol=1e-5, atol=1e-6,
              name=name)
    assert set(t_reg) == set(j_reg)
    for k in j_reg:
        close(t_reg[k], j_reg[k], rtol=1e-5, atol=1e-8, name=k)


def test_arena_seeding_matches(avatars):
    """create_from_pcd: the port's arena against the JAX one. The 3-NN
    squared distances come from |q|^2 + |p|^2 - 2 q.p in f32 in both, so
    they agree only to the cancellation bound 8 eps |p|^2_max, not
    relatively; the scales are compared through that bound."""
    ja, ta, _ = avatars
    pts, cols = ta.train.readPointCloud()
    params, aux = TG.create_from_pcd(pts, cols, 1024, False, 3, 32)
    assert torch.equal(aux.alive, torch.from_numpy(
        np.asarray(ja.gauss_aux.alive)))
    for f in ('xyz', 'rotation', 'opacity', 'features_dc', 'features_rest'):
        close(getattr(params, f), getattr(ja.gauss_params, f), rtol=0,
              atol=0, name=f)
    n = pts.shape[0]
    bound = 8 * np.finfo(np.float32).eps * float((pts ** 2).sum(1).max())
    d_t = np.exp(2 * to_np(params.scaling)[:n, 0])
    d_j = np.exp(2 * np.asarray(ja.gauss_params.scaling)[:n, 0])
    close(d_t, d_j, rtol=1e-5, atol=bound, name='mean 3-NN distance^2')
