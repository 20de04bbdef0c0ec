"""One full render of the tiny synthetic avatar: gsavatar_torch's
InferenceScene against gsavatar's `render(..., nr_cache=...)` with the
Pallas compositor in interpret mode, on the same weights and arena.

Gates as for the rasterizer (tests/test_torch_raster.py): mean image error
< 1e-4 and a fraction < 1e-3 of pixels off by more than 1e-2, because the
unstable sort may order equal-depth splats differently; the pair counts
and visibility must agree exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (ITERATION, JaxAvatar, TorchAvatar,
                          assert_render_gates)

from gsavatar_torch.evaluate import evaluate
from gsavatar_torch.inference import InferenceScene

from gsavatar.ops.rasterizer import RasterizeConfig
from gsavatar.renderer import render


@pytest.fixture(scope='module')
def renders():
    ja = JaxAvatar()
    ta = TorchAvatar(ja)
    h, w = ja.cfg.dataset.img_hw
    rc = RasterizeConfig(width=w, height=h, max_pairs=65536, chunk=32,
                         backend='pallas_interpret')

    @jax.jit
    def jax_render(variables, gview, camera, nr_cache):
        pkg = render(ja.converter, variables, gview, camera, ITERATION, rc,
                     jnp.zeros(3), nr_cache=nr_cache)
        return (jnp.clip(pkg.render, 0.0, 1.0), pkg.opacity_render,
                pkg.n_pairs, pkg.pair_overflow, pkg.radii)

    want = jax.device_get(jax_render(ja.variables, ja.gview, ja.camera,
                                     ja.nr_cache))
    scene = InferenceScene(ta.cfg, ta.train.metadata, ta.train.assets,
                           ta.state, device='cpu')
    pkg = scene.render_frame(ta.camera, ITERATION)
    return want, pkg, scene, ta


def test_render_matches_jax(renders):
    (img, alpha, n_pairs, overflow, radii), pkg, _, _ = renders
    assert pkg.pair_overflow == 0 and int(overflow) == 0
    assert pkg.n_pairs == int(n_pairs) > 0
    # the port renders the alive prefix; the JAX arena's dead tail is
    # invisible
    n = pkg.radii.shape[0]
    np.testing.assert_array_equal(pkg.radii.numpy(), np.asarray(radii)[:n])
    assert not np.asarray(radii)[n:].any()
    assert_render_gates(pkg.render.clamp(0, 1).numpy(), img, 'image')
    assert_render_gates(pkg.opacity_render.numpy(), alpha, 'alpha')
    assert float(pkg.opacity_render.mean()) > 0.01


def test_evaluate_loop_predict_mode(renders):
    """The evaluate render loop over the predict cameras: finite images in
    [0, 1], alpha coverage, no overflow, first frame excluded from the
    mean time."""
    _, _, scene, ta = renders
    cams = [ta.predict[i] for i in range(len(ta.predict))]
    res = evaluate(scene, cams, n_frames=3, keep_renders=True)
    assert len(res['frame_ms']) == 3
    assert res['time_ms'] == pytest.approx(np.mean(res['frame_ms'][1:]))
    assert res['pair_overflow'] == [0, 0, 0]
    for img, alpha in zip(res['images'], res['alphas']):
        assert img.shape == (64, 64, 3)
        assert bool(img.isfinite().all())
        assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0
        assert float(alpha.mean()) > 0.01
