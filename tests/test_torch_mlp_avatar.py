"""The MLP avatar (`perfbench/configs/zju377_mlp.json`: `non_rigid=mlp`,
8 x 256 on the 39-wide encoding with the 144-wide pose code at layer 0 and
a skip at 4; `texture=mlp`, 4 x 256) at its published widths, against the
benchmark's plain reference (`perfbench/reference/plain`) on the CPU.

Both sides take one seeded state dict (the reference's initialisation plus
the benchmark's noise, `perfbench.harness.inputs.make_weights`) over a
reduced synthetic body of a few hundred Gaussians, at iteration 15,000,
past the non-rigid delay (3,000) and the pose correction's (5,000), so
that every offset, the 64-wide feature and the corrected pose are live.
Compared: the deformed positions, scales and rotations, the non-rigid
feature, the colours, one 64 x 64 render (image and alpha) and the
gradient of one scalar loss for every converter parameter.

Tolerances, each a gap over its reference's largest magnitude (a
gradient: its norm's gap over its own norm). Both sides run the same f32
operations, so today they agree to the bit; the tolerances leave room for a
program that reorders an f32 sum (a fused concat, another GEMM split), whose
rounding moves an 8-layer, 256-wide product by about 1e-6 of its scale, and
refuse a lower precision: the same MLP weights rounded to bfloat16 (8 bits
of mantissa, a relative step of 2^-9) move the scales by 1.5e-5 of their
scale, the positions by 1.1e-4, the feature, image and alpha by 1.2e-3 to
1.4e-3, and the worst gradient by 0.17 of its norm (at SEED).
* `STATE_TOL` 1e-5, the positions, scales, rotations, feature and colours:
  the benchmark cell's own `xyz_gap` limit, ten times an f32 reordering;
* `IMAGE_TOL` 1e-5, image and alpha: a colour's or a splat's change passes
  through the compositor's sums at the same scale;
* `GRAD_TOL` 1e-4: a backward adds the 8 layers' products again in its own
  order, and a leaf's gradient is a sum over every Gaussian, so its
  rounding is ten times the forward's."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

import torch_dist_workers  # noqa: F401  (torch on one thread)

from gsavatar_torch.config import load_config

ROOT = Path(__file__).resolve().parent.parent
SEED = 2147483901
ITERATION = 15000
STATE_TOL = 1e-5
IMAGE_TOL = 1e-5
GRAD_TOL = 1e-4
# a reduced body and a few hundred Gaussians: widths and depths stay
# published, only the subject is cut
SMALL = {'img_hw': [64, 64], 'n_verts': 512, 'n_points': 384,
         'n_target_gaussians': 384}


def _config() -> dict:
    with open(ROOT / 'perfbench' / 'configs' / 'zju377_mlp.json') as f:
        over = json.load(f)['overrides']
    cfg = load_config(over)
    cfg['dataset'].update(SMALL)
    cfg['model']['gaussian']['capacity'] = 512
    return cfg


@pytest.fixture(scope='module')
def sides():
    """(cfg, weights, the program's modules, the reference's modules)."""
    from gsavatar_torch.core import gaussians as G
    from gsavatar_torch.data import load_dataset
    from gsavatar_torch.inference import raster_config_from
    from gsavatar_torch.models.converter import build_converter
    from gsavatar_torch.renderer import render
    from perfbench.harness import inputs
    from perfbench.reference.plain.core import gaussians as RG
    from perfbench.reference.plain.models.converter import \
        build_converter as ref_build
    from perfbench.reference.plain.ops.rasterizer import RasterizeConfig
    from perfbench.reference.plain.renderer import render as ref_render
    cfg = _config()
    w = inputs.make_weights(cfg, SEED, 'cpu')
    ds = load_dataset(cfg['dataset'], 'train')
    # the program's own buffers, the seed's parameters, as the playback
    # driver builds its avatar
    conv = build_converter(cfg, ds.metadata, ds.assets)
    state = conv.state_dict()
    state.update({k: w.conv[k] for k in w.trained})
    conv.load_state_dict(state)
    ref = ref_build(cfg, w.subject.metadata, w.subject.assets)
    ref.load_state_dict(w.conv)
    r = raster_config_from(cfg)
    prog = {'conv': conv, 'G': G, 'render': render, 'raster': r,
            'camera': ds._camera(0)}
    refs = {'conv': ref, 'G': RG, 'render': ref_render,
            'raster': RasterizeConfig(width=r.width, height=r.height,
                                      max_pairs=r.max_pairs,
                                      max_rect=r.max_rect),
            'camera': w.subject._camera(0)}
    return cfg, w, prog, refs


def _run(w, side, weights=None):
    """One render of the side's converter (its MLP weights replaced by
    `weights` where given) and the gradients of one scalar loss."""
    conv = side['conv']
    if weights is not None:
        saved = {k: v.clone() for k, v in conv.state_dict().items()}
        conv.load_state_dict(dict(saved, **weights))
    conv.zero_grad(set_to_none=True)
    G = side['G']
    n = int(w.alive.sum())
    params = G.GaussianParams(**{k: v.clone() for k, v in w.arena.items()})
    view = G.make_view(params, G.empty_aux(w.alive.shape[0]).replace(
        alive=w.alive.clone()), active_sh_degree=0, max_sh_degree=3,
        use_sh=False, bucket=n)
    pkg = side['render'](conv, view, side['camera'], ITERATION,
                         side['raster'], torch.zeros(3))
    d = pkg.deformed_gaussians
    out = {'xyz': d.params.xyz, 'scaling': d.params.scaling,
           'rotation': d.params.rotation, 'feature': d.non_rigid_feature,
           'colors': pkg.colors, 'image': pkg.render,
           'alpha': pkg.opacity_render}
    # fixed weights, so that every output takes part in the loss
    gen = torch.Generator().manual_seed(7)
    loss = sum((v * torch.rand(v.shape, generator=gen)).sum()
               for _, v in sorted(out.items()))
    loss.backward()
    out = {k: v.detach() for k, v in out.items()}
    grads = {k: p.grad for k, p in conv.named_parameters()}
    if weights is not None:
        conv.load_state_dict(saved)
    return out, grads


def _gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _gaps(prog, ref) -> dict:
    out, grads = prog
    rout, rgrads = ref
    gaps = {k: _gap(out[k], rout[k]) for k in rout}
    gaps['grad'] = max(
        float(torch.linalg.vector_norm(grads[k] - g)
              / torch.linalg.vector_norm(g).clamp_min(1e-30))
        for k, g in rgrads.items())
    return gaps


def _fails(gaps) -> list:
    tol = dict(image=IMAGE_TOL, alpha=IMAGE_TOL, grad=GRAD_TOL)
    return sorted(k for k, v in gaps.items()
                  if not v <= tol.get(k, STATE_TOL))


def test_the_configuration_runs_the_published_widths(sides):
    cfg, _, prog, _ = sides
    nr = prog['conv'].non_rigid.mlp
    tex = prog['conv'].texture.mlp
    # 39 + 144 in at layer 0; the layer before the skip gives up 39 outputs
    widths = [(l.in_features, l.out_features) for l in
              (getattr(nr, f'lin{i}') for i in range(nr.n_layers))]
    assert widths == [(183, 256), (256, 256), (256, 256), (256, 217),
                      (256, 256), (256, 256), (256, 256), (256, 256),
                      (256, 74)]
    assert (nr.cond_in, nr.skip_in) == ((0,), (4,))
    widths = [(l.in_features, l.out_features) for l in
              (getattr(tex, f'lin{i}') for i in range(tex.n_layers))]
    assert widths == [(271, 256), (256, 256), (256, 256), (256, 256),
                      (256, 3)]
    assert ITERATION == cfg['opt']['iterations'] > \
        cfg['model']['deformer']['non_rigid']['delay']


def test_the_port_matches_the_plain_reference(sides):
    _, w, prog, refs = sides
    p, r = _run(w, prog), _run(w, refs)
    assert p[0]['feature'].shape == (int(w.alive.sum()), 64)
    # the offsets are live: the deformed state is not the canonical one
    assert not torch.equal(p[0]['xyz'], w.arena['xyz'][:p[0]['xyz'].shape[0]])
    assert float(r[0]['alpha'].max()) > 0.5
    assert all(float(torch.linalg.vector_norm(g)) > 0
               for g in r[1].values())
    assert set(p[1]) == set(r[1])
    gaps = _gaps(p, r)
    assert _fails(gaps) == [], gaps


def test_mlp_weights_in_bfloat16_fail(sides):
    _, w, prog, refs = sides
    rounded = {k: v.to(torch.bfloat16).float()
               for k, v in prog['conv'].state_dict().items()
               if k.startswith(('non_rigid.mlp.', 'texture.mlp.'))
               and k.endswith('.weight')}
    assert len(rounded) == 9 + 5
    gaps = _gaps(_run(w, prog, rounded), _run(w, refs))
    assert _fails(gaps), gaps
