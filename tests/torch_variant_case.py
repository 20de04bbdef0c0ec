"""One model variant of the tiny synthetic avatar in both packages, for the
converter parity tests (tests/test_torch_variant_*.py).

`VariantCase(overrides)` builds the JAX avatar of the variant
(torch_parity.JaxAvatar: weights drawn with numpy from a seed), the
port's converter from the same config with those weights carried through
gsavatar_torch.convert (loaded strictly, so every leaf of the flax tree
has its parameter), random colour features in both arenas, and the JAX
'subject' constants filled from the port's buffers of the same names
(which asserts that both packages keep the same constants). It then runs:

* `forward(iteration)`: the converter at eval (no cache) in both;
* `gradients()`: one scalar of the outputs (random weights on the
  positions, covariances and colours of the alive slots, and on every
  regularizer) through `jax.value_and_grad` and through autograd, with
  respect to the converter's parameters, the subject constants and the
  arena's parameters.

The JAX forward is jitted once with the iteration traced; its gradient
runs eagerly under the hash-grid deformer and jitted otherwise."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import JaxAvatar, TorchAvatar

from gsavatar_torch import convert
from gsavatar_torch.core import gaussians as TG
from gsavatar_torch.models.converter import build_converter

from gsavatar.core import gaussians as JG

ITERATION = 15000      # past every gate: delays, kick-in, full band
FIELDS = ('xyz', 'features_dc', 'features_rest', 'scaling', 'rotation',
          'opacity')


def _key(k) -> str:
    return str(getattr(k, 'key', getattr(k, 'name', getattr(k, 'idx', k))))


def subject_names(tree) -> list:
    return ['.'.join(_key(k) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


class VariantCase:
    def __init__(self, overrides, seed: int = 0):
        self.overrides = list(overrides)
        ja = JaxAvatar(seed=seed, overrides=self.overrides)
        ta = TorchAvatar(ja, overrides=self.overrides)
        self.ja, self.ta = ja, ta
        self.conv = build_converter(ta.cfg, ta.train.metadata,
                                    ta.train.assets)
        self.conv.load_state_dict(ta.state.converter)
        self.conv.eval()

        g = ta.cfg['model']['gaussian']
        self.use_sh = bool(g['use_sh'])
        deg = 3 if self.use_sh else 0
        rng = np.random.default_rng(seed + 100)
        jp = ja.gauss_params
        feats = {f: rng.normal(scale=0.5, size=getattr(jp, f).shape)
                 .astype(np.float32) for f in ('features_dc', 'features_rest')}
        self.j_params = jp.replace(**{k: jnp.asarray(v)
                                      for k, v in feats.items()})
        self.t_params = ta.state.gauss_params.replace(
            **{k: torch.from_numpy(v) for k, v in feats.items()})
        self.jview = JG.make_view(self.j_params, ja.gauss_aux,
                                  active_sh_degree=deg, use_sh=self.use_sh)
        self.tview = TG.make_view(self.t_params, ta.state.gauss_aux,
                                  active_sh_degree=deg, use_sh=self.use_sh)
        self.alive = np.asarray(ja.gauss_aux.alive)

        buffers = self.conv.subject_constants()
        shapes = ja.shapes.get('subject', {})
        assert sorted(subject_names(shapes)) == sorted(buffers), (
            subject_names(shapes), sorted(buffers))

        def fill(path, s):
            b = buffers['.'.join(_key(k) for k in path)]
            assert tuple(b.shape) == tuple(s.shape)
            return jnp.asarray(b.numpy())

        self.subject = jax.tree_util.tree_map_with_path(fill, shapes)
        self.variables = {'params': jax.tree.map(jnp.asarray, ja.params)}
        if buffers:
            self.variables['subject'] = self.subject

        n = self.alive.shape[0]
        self.weights = {k: rng.normal(size=(n, c)).astype(np.float32)
                        for k, c in (('xyz', 3), ('cov', 6), ('rgb', 3))}
        self.reg_weight = float(rng.uniform(0.5, 1.5))
        self._j_fwd = jax.jit(self._jax_forward)

    # -- the JAX side -------------------------------------------------------
    def _jax_forward(self, variables, gview, iteration):
        d, reg, col = self.ja.converter.apply(variables, gview,
                                              self.ja.camera, iteration)
        return d.get_xyz, d.get_covariance(), d.get_opacity, col, reg

    def _jax_scalar(self, params, subject, gauss):
        variables = {'params': params}
        if subject:
            variables['subject'] = subject
        gview = self.jview.replace(params=gauss)
        xyz, cov, _, col, reg = self._jax_forward(variables, gview,
                                                  jnp.int32(ITERATION))
        a = jnp.asarray(self.alive, jnp.float32)[:, None]
        w = self.weights
        s = (jnp.sum(xyz * w['xyz'] * a) + jnp.sum(cov * w['cov'] * a)
             + jnp.sum(col * w['rgb'] * a))
        for v in reg.values():
            s = s + self.reg_weight * v
        return s

    # -- the port -----------------------------------------------------------
    def _torch_scalar(self, gauss):
        view = self.tview.replace(params=gauss)
        d, reg, col = self.conv(view, self.ta.camera, ITERATION)
        a = torch.from_numpy(self.alive).float()[:, None]
        w = {k: torch.from_numpy(v) for k, v in self.weights.items()}
        s = ((d.get_xyz * w['xyz'] * a).sum()
             + (d.get_covariance() * w['cov'] * a).sum()
             + (col * w['rgb'] * a).sum())
        for v in reg.values():
            s = s + self.reg_weight * v
        return s

    def forward(self, iteration: int):
        """(jax, port): each (xyz, cov, opacity, colours, regularizers)."""
        want = self._j_fwd(self.variables, self.jview, jnp.int32(iteration))
        with torch.no_grad():
            d, reg, col = self.conv(self.tview, self.ta.camera, iteration)
        return want, (d.get_xyz, d.get_covariance(), d.get_opacity, col, reg)

    def gradients(self):
        """{'value', 'conv', 'subject', 'gauss'} for JAX and for the port,
        each leaf a numpy array under the port's name."""
        if not hasattr(self, '_grads'):
            # eagerly under the hash grid: under jit XLA reorders the sums
            # of its input gradient, which then moves by up to 1.5e-4 of
            # its scale at a fifth of the Gaussians; the port follows the
            # eager JAX function to 4e-7 (as the render path's hash-grid
            # cache follows the eager one, ROADMAP section 3, PR 1). The
            # other deformers agree with the jitted gradient as well
            fn = jax.value_and_grad(self._jax_scalar, argnums=(0, 1, 2))
            nr = self.ta.cfg['model']['deformer']['non_rigid']['name']
            if nr != 'hashgrid':
                fn = jax.jit(fn)
            value, (gp, gs, gg) = fn(self.variables['params'], self.subject,
                                     self.j_params)
            want = {'value': float(value),
                    'conv': {k: v.numpy() for k, v in convert.converter_state(
                        jax.tree.map(np.asarray, gp)).items()},
                    'subject': dict(zip(subject_names(gs),
                                        map(np.asarray,
                                            jax.tree.leaves(gs)))),
                    'gauss': {f: np.asarray(getattr(gg, f)) for f in FIELDS}}
            consts = self.conv.subject_constants()
            params = dict(self.conv.named_parameters())
            gauss = self.t_params.map(lambda x: x.detach().requires_grad_())
            for c in consts.values():
                c.requires_grad_(True)
            try:
                value = self._torch_scalar(gauss)
                leaves = (list(params.values()) + list(consts.values())
                          + [getattr(gauss, f) for f in FIELDS])
                grads = torch.autograd.grad(value, leaves, allow_unused=True)
            finally:
                for c in consts.values():
                    c.requires_grad_(False)
            grads = [np.zeros(tuple(x.shape), np.float32) if g is None
                     else g.numpy() for g, x in zip(grads, leaves)]
            names = (list(params) + list(consts) + [f'gauss.{f}'
                                                    for f in FIELDS])
            flat = dict(zip(names, grads))
            got = {'value': float(value.detach()),
                   'conv': {k: flat[k] for k in params},
                   'subject': {k: flat[k] for k in consts},
                   'gauss': {f: flat[f'gauss.{f}'] for f in FIELDS}}
            self._grads = want, got
            self._jax_grads = {'params': gp, 'subject': gs}
        return self._grads

    def _jax_grad_tree(self):
        """The JAX gradients as the tree of `variables`."""
        self.gradients()
        tree = {'params': self._jax_grads['params']}
        if 'subject' in self.variables:
            tree['subject'] = self._jax_grads['subject']
        return tree


# the variants of the chip's phase, at cut widths: the deformer MLPs 64 x 5
# (64: the layer before the skip at 4 gives up the 39 encoded columns), the
# distilled voxel at res 16 (4 x 16 x 16), the wide texture's MLP 64 x 2
# beside its published 128 features and 64-wide latent and feature
SMALL_NR = ["model.deformer.non_rigid.mlp.n_neurons=64",
            "model.deformer.non_rigid.mlp.n_hidden_layers=5"]
VARIANTS = {
    'v_mlp': ['non_rigid=mlp'] + SMALL_NR,
    'v_hannw_sh': ['non_rigid=hannw_mlp', 'texture=sh'] + SMALL_NR,
    'v_smpl_nn': ['rigid=smpl_nn'],
    'v_distill': ['model.deformer.rigid.distill=true',
                  'model.deformer.rigid.res=16'],
    'v_3dgs': ['texture=sh', 'non_rigid=identity', 'rigid=identity',
               'pose_correction=none'],
    'v_wide_tex': ['texture=mlp', 'model.texture.mlp.n_neurons=64',
                   'model.texture.mlp.n_hidden_layers=2'],
}
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol, atol, name):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol, err_msg=name)


def _grad_close(got, want, name, rel=1e-5):
    """Within `rel` of the leaf's largest |value| (the gradient sums over
    every Gaussian in another order)."""
    scale = float(np.abs(want).max()) if np.size(want) else 0.0
    _close(got, want, 0, rel * max(scale, 1e-12), name)


def test_converter_forward(case):
    """The converter at eval, before the gates (2000: non-rigid delay and
    Hann kick-in at 3000), inside the Hann window (6000) and past every
    gate: positions, covariances, opacities, colours of the alive slots
    and every regularizer, the same keys in both."""
    for it in (2000, 6000, ITERATION):
        want, got = case.forward(it)
        for name, g, w in zip(('xyz', 'cov', 'opacity', 'colors'), got[:4],
                              want[:4]):
            _close(g.numpy()[case.alive], np.asarray(w)[case.alive], RTOL,
                   ATOL, f'{name} at {it}')
        assert set(got[4]) == set(want[4]), it
        for k in want[4]:
            _close(got[4][k], want[4][k], RTOL, 1e-7, f'{k} at {it}')


def test_converter_gradients(case):
    """Every converter parameter and every arena leaf."""
    want, got = case.gradients()
    _close(got['value'], want['value'], RTOL, ATOL, 'scalar')
    assert set(got['conv']) == set(want['conv'])
    for k, w in want['conv'].items():
        _grad_close(got['conv'][k], w, k)
    for f, w in want['gauss'].items():
        _grad_close(got['gauss'][f], w, f)
    assert any(np.abs(w).max() > 0 for w in want['gauss'].values())


def test_subject_constant_gradients(case):
    """The frozen constants (AABBs, template vertices and skinning weights,
    SMPL tables): the same names and the same gradients. Each of an AABB's
    six numbers is one sum over every Gaussian whose terms cancel, so the
    AABBs are held to 1e-4 of the leaf's largest |value|, the tables to
    1e-5."""
    want, got = case.gradients()
    assert set(got['subject']) == set(want['subject'])
    for k, w in want['subject'].items():
        _grad_close(got['subject'][k], w, k,
                    1e-4 if '.aabb.' in k else 1e-5)


def test_clip_norm_and_optimizer(case):
    """The global norm of the clip (parameters and subject constants)
    against optax's, then two steps of the port's ConverterOptimizer and of
    the JAX package's optax chain, both given the JAX gradients: the
    updates within 1e-4 relative (Adam divides two rounded moments)."""
    import optax
    from gsavatar.scene import converter_optimizer
    from gsavatar_torch.scene import ConverterOptimizer
    want, got = case.gradients()
    norm = lambda g: np.sqrt(sum(float((np.asarray(x, np.float64) ** 2).sum())
                                 for d in (g['conv'], g['subject'])
                                 for x in d.values()))
    _close(norm(got), norm(want), 1e-5, 0, 'global norm')

    jcfg = case.ja.cfg
    iterations = int(jcfg.opt.iterations)
    tx = converter_optimizer(jcfg, iterations)
    j_vars = case.variables
    j_state = tx.init(j_vars)
    port = ConverterOptimizer(case.ta.cfg, iterations)
    t_params = {k: p.detach().clone()
                for k, p in case.conv.named_parameters()}
    t_state = port.init(t_params)
    by_name = {k: torch.from_numpy(v) for k, v in want['conv'].items()}
    frozen = {k: torch.from_numpy(v) for k, v in want['subject'].items()}
    j_params0 = {k: v.numpy().copy() for k, v in convert.converter_state(
        jax.tree.map(np.asarray, j_vars['params'])).items()}
    for scale in (1.0, -0.6):
        grads_tree = jax.tree.map(lambda x: scale * x,
                                  case._jax_grad_tree())
        updates, j_state = tx.update(grads_tree, j_state, j_vars)
        j_vars = optax.apply_updates(j_vars, updates)
        t_state = port.step(t_params, {k: scale * v
                                       for k, v in by_name.items()},
                            t_state, frozen_grads={k: scale * v for k, v in
                                                   frozen.items()})
    assert t_state.count == 2
    j_params = {k: v.numpy() for k, v in convert.converter_state(
        jax.tree.map(np.asarray, j_vars['params'])).items()}
    assert set(j_params) == set(t_params)
    for k, p in t_params.items():
        du_t = p.numpy() - j_params0[k]
        du_j = j_params[k] - j_params0[k]
        _close(du_t, du_j, 1e-4, 1e-9, k)
    if 'subject' in j_vars:
        for a, b in zip(jax.tree.leaves(j_vars['subject']),
                        jax.tree.leaves(case.subject)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
