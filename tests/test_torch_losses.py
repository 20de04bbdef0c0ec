"""gsavatar_torch's loss terms, optimizers and training leaves against
gsavatar's on the CPU: SSIM, LPIPS (random VGG weights), L1, mask, AIAP
(both JAX forms), opacity entropy, the foreground crop, PSNR, the C()
schedule, the arena Adam and the converter optimizer over two steps, the
densify statistics, the neighbour search, the skinning pool, the view-noise
rotation and the position learning-rate schedule.

Tolerances: 1e-6 relative for elementwise terms and short sums; 1e-5 where
convolutions, 11x11 windows or thousands of terms are summed in another
order (SSIM, LPIPS, the AIAP means); optimizer states and parameters 1e-6
relative (the updates are elementwise); the LPIPS gradient with a cosine
> 0.9999 and 1e-4 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, to_np

from gsavatar_torch import losses as TL
from gsavatar_torch.core import densify as tdensify
from gsavatar_torch.core import gaussians as TG
from gsavatar_torch.core import optim as toptim
from gsavatar_torch.ops import knn as tknn
from gsavatar_torch.ops import lpips as tlpips
from gsavatar_torch.ops import sampling as tsampling
from gsavatar_torch.ops.ssim import ssim as t_ssim
from gsavatar_torch.scene import ConverterOptimizer
from gsavatar_torch.utils import transforms as TT

from gsavatar import losses as JL
from gsavatar.core import densify as jdensify
from gsavatar.core import gaussians as JG
from gsavatar.core import optim as joptim
from gsavatar.ops import knn as jknn
from gsavatar.ops import lpips as jlpips
from gsavatar.ops import sampling as jsampling
from gsavatar.ops.ssim import ssim as j_ssim
from gsavatar.scene import converter_optimizer
from gsavatar.utils import transforms as JT

rng = np.random.default_rng(0)
IMG = rng.random((48, 40, 3)).astype(np.float32)
IMG2 = np.clip(IMG + rng.normal(0, 0.1, IMG.shape), 0, 1).astype(np.float32)
ALPHA = rng.random((48, 40)).astype(np.float32)
MASK = np.zeros((48, 40), np.float32)
MASK[10:30, 5:25] = 1.0
T = torch.from_numpy


def test_ssim():
    close(t_ssim(T(IMG), T(IMG2)), j_ssim(jnp.asarray(IMG), jnp.asarray(IMG2)),
          1e-5, 1e-7)


def test_lpips_random_vgg_weights_identical():
    want = jlpips.random_weights(net='vgg')
    got = tlpips.random_weights()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)


def test_lpips_value_and_gradient():
    a, b = IMG[:32, :32], IMG2[:32, :32]
    want, j_grad = jax.jit(jax.value_and_grad(
        lambda x, y: jlpips.lpips(x, y, compute_dtype=jnp.float32)))(
            jnp.asarray(a), jnp.asarray(b))
    x = T(np.ascontiguousarray(a)).requires_grad_()
    got = tlpips.lpips(x, T(np.ascontiguousarray(b)))
    (t_grad,) = torch.autograd.grad(got, x)
    close(got, want, 1e-5, 1e-8)
    g, w = to_np(t_grad).ravel(), np.asarray(j_grad).ravel()
    assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) > 0.9999
    close(g, w, 1e-4, 1e-4 * np.abs(w).max())


@pytest.mark.parametrize('kw', [dict(padding=1), dict(stride=2, padding=0),
                                dict(padding=(5, 0), groups=3)],
                         ids=['lpips', 'strided', 'ssim_depthwise'])
def test_conv2d_f32_matches_conv2d(kw):
    """The convolution SSIM and LPIPS own: forward and every gradient equal
    `F.conv2d`'s (on the CPU the TF32 flag it turns off changes nothing)."""
    from gsavatar_torch.ops.conv import conv2d_f32
    groups = kw.get('groups', 1)
    r = np.random.default_rng(3)
    x = T(r.standard_normal((1, 3, 17, 15)).astype(np.float32))
    w = T(r.standard_normal((6, 3 // groups, 3, 3)).astype(np.float32))
    b = T(r.standard_normal(6).astype(np.float32))
    flag = torch.backends.cudnn.allow_tf32
    grads = []
    for fn in (conv2d_f32, torch.nn.functional.conv2d):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        y = fn(*leaves, **kw)
        ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
        grads.append([y] + list(torch.autograd.grad(y, leaves, ct)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.backends.cudnn.allow_tf32 == flag  # the caller's, restored


def test_conv2d_f32_holds_cudnn_to_f32_and_deterministic(monkeypatch):
    """Both passes run with cuDNN's TF32 off and its deterministic
    algorithms on (the backward's default algorithms sum in a run-dependent
    order on the card), and the caller's flags come back after each."""
    from gsavatar_torch.ops import conv
    cudnn = torch.backends.cudnn
    seen = []
    fwd, bwd = torch.nn.functional.conv2d, torch.ops.aten.convolution_backward

    def record(fn):
        def wrapped(*a, **k):
            seen.append((cudnn.allow_tf32, cudnn.deterministic))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(conv.F, 'conv2d', record(fwd))
    monkeypatch.setattr(conv.torch.ops.aten, 'convolution_backward',
                        record(bwd), raising=False)
    before = cudnn.allow_tf32, cudnn.deterministic
    x = torch.randn((1, 3, 9, 9), requires_grad=True)
    w = torch.randn((4, 3, 3, 3), requires_grad=True)
    y = conv.conv2d_f32(x, w, padding=1)
    assert (cudnn.allow_tf32, cudnn.deterministic) == before
    torch.autograd.grad(y.sum(), (x, w))
    assert seen == [(False, True), (False, True)]
    assert (cudnn.allow_tf32, cudnn.deterministic) == before


@pytest.mark.parametrize('name', ['l1', 'mask_l1', 'mask_bce', 'psnr',
                                  'opacity_entropy'])
def test_image_and_opacity_terms(name):
    alive = np.arange(ALPHA.size) % 7 != 0
    cases = {
        'l1': lambda m, x: m.l1_loss(x(IMG), x(IMG2)),
        'mask_l1': lambda m, x: m.mask_loss(x(ALPHA), x(MASK), 'l1'),
        'mask_bce': lambda m, x: m.mask_loss(x(ALPHA), x(MASK), 'bce'),
        'psnr': lambda m, x: m.psnr(x(IMG), x(IMG2)),
        'opacity_entropy': lambda m, x: m.opacity_entropy_loss(
            x(ALPHA.reshape(-1, 1)), x(alive)),
    }
    close(cases[name](TL, T), cases[name](JL, jnp.asarray), 1e-6, 1e-8, name)


@pytest.mark.parametrize('value', [0.5, [10, 1000, 0.1], [0, 100, 1, 500, 2]])
def test_C_schedule(value):
    for it in (0, 99, 100, 499, 500, 1000, 5000):
        assert TL.C(it, value) == JL.C(it, value)


def test_foreground_crop():
    for crop in ((16, 20), (64, 64)):
        tr, tg = TL.foreground_crop(T(IMG), T(IMG2), T(MASK), crop)
        jr, jg = JL.foreground_crop(jnp.asarray(IMG), jnp.asarray(IMG2),
                                    jnp.asarray(MASK), crop)
        close(tr, jr, 0, 0)
        close(tg, jg, 0, 0)


def _gaussians(n, seed):
    """A canonical and a deformed view of n random Gaussians, in both
    packages (the deformed one with precomputed rotations)."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    p = dict(xyz=f(n, 3), features_dc=f(n, 1, 1), features_rest=f(n, 31, 1),
             scaling=f(n, 3) * 0.3 - 3.0, rotation=f(n, 4), opacity=f(n, 1))
    alive = np.arange(n) % 9 != 4
    xyz_obs = p['xyz'] + 0.05 * f(n, 3)
    rot_obs = np.asarray(JT.quat_to_rotmat(jnp.asarray(f(n, 4))))
    j_can = JG.Gaussians(params=JG.GaussianParams(**{
        k: jnp.asarray(v) for k, v in p.items()}), alive=jnp.asarray(alive))
    t_can = TG.Gaussians(params=TG.GaussianParams(**{
        k: T(v) for k, v in p.items()}), alive=T(alive))
    j_obs = j_can.replace(params=j_can.params.replace(
        xyz=jnp.asarray(xyz_obs)), rotation_precomp=jnp.asarray(rot_obs))
    t_obs = t_can.replace(params=t_can.params.replace(xyz=T(xyz_obs)),
                          rotation_precomp=T(rot_obs))
    return j_can, t_can, j_obs, t_obs


def test_full_aiap_loss_matches_both_jax_forms():
    """The columnar form against JAX's columnar full_aiap_loss and its
    single-attribute aiap_loss, on cached neighbours; and the xyz
    gradient, which reaches the positions through gather_rows' K3."""
    j_can, t_can, j_obs, t_obs = _gaussians(300, 1)
    nn_ix = np.asarray(jknn.knn_self(j_can.get_xyz, 5, mask=j_can.alive))
    want = JL.full_aiap_loss(j_can, j_obs, nn_ix=jnp.asarray(nn_ix))
    xyz = t_can.params.xyz.clone().requires_grad_()
    t_can = t_can.replace(params=t_can.params.replace(xyz=xyz))
    got = TL.full_aiap_loss(t_can, t_obs, nn_ix=T(nn_ix))
    for g, w in zip(got, want):
        close(g, w, 1e-5, 1e-9)
    single = (JL.aiap_loss(j_can.get_xyz, j_obs.get_xyz, jnp.asarray(nn_ix),
                           j_can.alive),
              JL.aiap_loss(j_can.get_covariance(), j_obs.get_covariance(),
                           jnp.asarray(nn_ix), j_can.alive))
    for g, w in zip(got, single):
        close(g, w, 1e-5, 1e-9)
    close(TL.aiap_loss(xyz, t_obs.get_xyz, T(nn_ix), t_can.alive),
          single[0], 1e-5, 1e-9)

    def j_total(x):
        c = j_can.replace(params=j_can.params.replace(xyz=x))
        ax, ac = JL.full_aiap_loss(c, j_obs, nn_ix=jnp.asarray(nn_ix))
        return ax + 100.0 * ac

    j_grad = jax.grad(j_total)(j_can.get_xyz)
    (t_grad,) = torch.autograd.grad(got[0] + 100.0 * got[1], xyz)
    close(t_grad, j_grad, 1e-4, 1e-4 * float(np.abs(j_grad).max()))


def test_knn_self_distances():
    """Neighbour distances agree (ties may order indices differently);
    dead slots are nobody's neighbour."""
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    alive = np.arange(700) % 5 != 0
    want = np.asarray(jknn.knn_self(jnp.asarray(pts), 5,
                                    mask=jnp.asarray(alive)))
    got = tknn.knn_self(T(pts), 5, mask=T(alive)).numpy()
    assert got.shape == (700, 5) and got.dtype == np.int32
    d = lambda ix: np.linalg.norm(pts[ix] - pts[:, None], axis=-1)
    close(d(got)[alive], d(want)[alive], 1e-5, 1e-6)
    assert alive[got[alive]].all()


def test_skinning_pool_identical():
    r = np.random.default_rng(2)
    verts = r.normal(size=(60, 3)).astype(np.float32)
    faces = r.integers(0, 60, size=(100, 3))
    w = r.random((60, 24)).astype(np.float32)
    for a, b in zip(tsampling.sample_skinning_pool(verts, faces, w, 512),
                    jsampling.sample_skinning_pool(verts, faces, w, 512)):
        np.testing.assert_array_equal(a, b)


def test_augm_rot_matrix_from_the_jax_angles():
    """The angles JAX's augm_rot_matrix draws from a key, handed to the
    port's, give the same rotation."""
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = JT.augm_rot_matrix(key, 45, 45, 45)
        k1, k2, k3 = jax.random.split(key, 3)
        angles = [jnp.clip(jax.random.normal(k1) * 45, -90, 90),
                  jnp.clip(jax.random.uniform(k2) * 45, -90, 90),
                  jnp.clip(jax.random.normal(k3) * 45, -90, 90)]
        got = TT.augm_rot_matrix(*[T(np.asarray(a)) for a in angles])
        close(got, want, 1e-6, 1e-6)


def test_expon_lr_schedule():
    kw = dict(lr_init=0.00016 * 3.0, lr_final=1.6e-6 * 3.0,
              lr_delay_mult=0.01, max_steps=30000)
    jf, tf = JT.expon_lr_schedule(**kw), TT.expon_lr_schedule(**kw)
    for step in (0, 1, 1000, 14999, 30000, 40000):
        assert abs(tf(step) - float(jf(step))) <= 1e-6 * float(jf(step))


def _arena(n, seed, zero=False):
    r = np.random.default_rng(seed)
    f = lambda *s: (np.zeros(s) if zero else r.normal(size=s)).astype(
        np.float32)
    return dict(xyz=f(n, 3), features_dc=f(n, 1, 1),
                features_rest=f(n, 31, 1), scaling=f(n, 3),
                rotation=f(n, 4), opacity=f(n, 1))


def test_arena_adam_two_steps():
    """Two steps (the second after the delay gate opens), with dead slots:
    moments, step and parameters."""
    n = 50
    alive = np.arange(n) % 4 != 1
    lrs = {'xyz': 1.6e-4, 'features_dc': 1e-3, 'features_rest': 1e-3,
           'opacity': 0.05, 'scaling': 5e-3, 'rotation': 1e-3}
    jp = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in
                              _arena(n, 0).items()})
    tp = TG.GaussianParams(**{k: T(v) for k, v in _arena(n, 0).items()})
    js, ts = joptim.init_adam(jp), toptim.init_adam(tp)
    for i, apply in enumerate((False, True, True)):
        g = _arena(n, 10 + i)
        jp, js = joptim.adam_step(
            jp, JG.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()}),
            js, lrs, jnp.asarray(alive), apply=apply)
        tp, ts = toptim.adam_step(
            tp, TG.GaussianParams(**{k: T(v) for k, v in g.items()}),
            ts, lrs, T(alive), apply=apply)
        assert ts.step == int(js.step)
        for f in toptim.FIELDS:
            for a, b in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
                close(getattr(a, f), getattr(b, f), 1e-6, 1e-9, f)


def test_converter_optimizer_two_steps():
    """The clip (on: a large first gradient; off: a small second one), the
    decayed weights of the latent groups, Adam and the decaying step,
    against the JAX package's optax chain on a tree with one leaf per
    group."""
    from gsavatar.config import load_config
    cfg = load_config(overrides=["dataset=synthetic"])
    r = np.random.default_rng(4)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    leaves = {'rigid.lbs_network.lin0.weight': ('rigid', 'lbs_network',
                                                'lin0', 'kernel'),
              'non_rigid.hashgrid.table': ('non_rigid', 'hashgrid', 'table'),
              'texture.latent.weight': ('texture', 'latent', 'embedding'),
              'texture.mlp.lin0.bias': ('texture', 'mlp', 'lin0', 'bias'),
              'pose_correction.betas': ('pose_correction', 'betas')}
    params = {k: f(6, 4) for k in leaves}

    def tree(values):
        out = {}
        for k, path in leaves.items():
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(values[k])
        return {'params': out}

    def untree(t):
        out = {}
        for k, path in leaves.items():
            node = t['params']
            for p in path:
                node = node[p]
            out[k] = np.asarray(node)
        return out

    tx = converter_optimizer(cfg, 15000)
    j_params = tree(params)
    j_state = tx.init(j_params)
    t_params = {k: T(v.copy()) for k, v in params.items()}
    opt = ConverterOptimizer({'opt': dict(cfg.opt)}, 15000)
    t_state = opt.init(t_params)
    for scale in (1.0, 1e-3):
        grads = {k: f(6, 4) * scale for k in leaves}
        upd, j_state = tx.update(tree(grads), j_state, j_params)
        j_params = jax.tree.map(lambda p, u: p + u, j_params, upd)
        t_state = opt.step(t_params, {k: T(v) for k, v in grads.items()},
                           t_state)
        want = untree(j_params)
        for k in leaves:
            close(t_params[k], want[k], 1e-6, 1e-9, k)
    assert t_state.count == 2


def test_add_stats_prefix():
    """Densify statistics over a bucketed prefix: visible alive slots
    accumulate their screen-gradient norm, count and largest radius; the
    rows past the prefix keep theirs."""
    n, b = 40, 32
    r = np.random.default_rng(7)
    aux = dict(alive=np.arange(n) % 6 != 2,
               max_radii2d=r.integers(0, 5, n).astype(np.float32),
               xyz_gradient_accum=r.random(n).astype(np.float32),
               denom=r.integers(0, 3, n).astype(np.float32),
               nn_ix=np.zeros((n, 5), np.int32))
    grad = r.normal(size=(b, 2)).astype(np.float32)
    radii = (r.integers(0, 8, b) * (r.random(b) > 0.3)).astype(np.int32)
    want = jdensify.add_stats_prefix(
        JG.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()}),
        jnp.asarray(grad), jnp.asarray(radii))
    got = tdensify.add_stats_prefix(
        TG.GaussianAux(**{k: T(v) for k, v in aux.items()}), T(grad),
        T(radii))
    for f in ('max_radii2d', 'xyz_gradient_accum', 'denom'):
        close(getattr(got, f), getattr(want, f), 1e-6, 1e-9, f)
