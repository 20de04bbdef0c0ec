"""The evaluation outputs of the port against the JAX package's:
LPIPS-Alex (weights, value, gradient, and the size under which both report
NaN), `PSEvaluator`, the saved PNG frames and composites, results.npz,
`main`'s run suffixes and `InferenceScene.load_ply`.

Tolerances: LPIPS and the PeopleSnapshot metrics 1e-5 relative (f32
convolutions summed in another order); the gradient in cosine > 0.9999;
the random weights, the frames' pixels, the composites, the suffixes and
the loaded arena exact; the ply render to the render gates of
tests/test_torch_render.py."""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_parity import (ITERATION, JaxAvatar, TorchAvatar,
                          assert_render_gates, close, random_conv_params,
                          to_np)

from gsavatar_torch import evaluate as t_eval
from gsavatar_torch import metrics as tmetrics
from gsavatar_torch.ops import lpips as tlpips

from gsavatar import evaluate as j_eval
from gsavatar import metrics as jmetrics
from gsavatar.ops import lpips as jlpips

rng = np.random.default_rng(1)
IMG = rng.random((64, 48, 3)).astype(np.float32)
IMG2 = np.clip(IMG + rng.normal(0, 0.1, IMG.shape), 0, 1).astype(np.float32)
MASK = np.zeros((64, 48), np.float32)
MASK[10:50, 5:40] = 1.0
T = torch.from_numpy


def test_lpips_random_alex_weights_identical():
    want = jlpips.random_weights(net='alex')
    got = tlpips.random_weights(net='alex')
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    assert tlpips.metric_key('alex') == jlpips.metric_key('alex')


def test_lpips_alex_value_and_gradient():
    a, b = IMG[:40, :36], IMG2[:40, :36]
    want, j_grad = jax.jit(jax.value_and_grad(
        lambda x, y: jlpips.lpips(x, y, net='alex',
                                  compute_dtype=jnp.float32)))(
            jnp.asarray(a), jnp.asarray(b))
    x = T(np.ascontiguousarray(a)).requires_grad_()
    got = tlpips.lpips(x, T(np.ascontiguousarray(b)), net='alex')
    (t_grad,) = torch.autograd.grad(got, x)
    close(got, want, 1e-5, 1e-8)
    g, w = to_np(t_grad).ravel(), np.asarray(j_grad).ravel()
    assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) > 0.9999


def test_min_sizes():
    assert tlpips.min_size('vgg') == 16
    assert tlpips.min_size('alex') == 31


@pytest.mark.parametrize('net,side', [('alex', 30), ('alex', 31),
                                      ('vgg', 15), ('vgg', 16)])
def test_lpips_nan_below_the_least_size_as_jax(net, side):
    """Both packages give NaN below the least side and a value at it."""
    a, b = IMG[:side, :side + 5], IMG2[:side, :side + 5]
    want = float(jlpips.lpips(jnp.asarray(a), jnp.asarray(b), net=net,
                              compute_dtype=jnp.float32))
    got = float(tlpips.lpips(T(np.ascontiguousarray(a)),
                             T(np.ascontiguousarray(b)), net=net))
    assert np.isnan(got) == np.isnan(want) == (side < tlpips.min_size(net))
    if not np.isnan(want):
        assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize('shape', [(64, 48), (30, 40)])
def test_ps_evaluator_matches_jax(shape):
    h, w = shape
    a, b, m = IMG[:h, :w], IMG2[:h, :w], MASK[:h, :w]
    want = jmetrics.get_evaluator('people_snapshot')(a, b, valid_mask=m > 0)
    ev = tmetrics.get_evaluator('people_snapshot')
    assert isinstance(ev, tmetrics.PSEvaluator)
    got = ev(T(np.ascontiguousarray(a)), T(np.ascontiguousarray(b)),
             valid_mask=T(np.ascontiguousarray(m)))
    assert set(got) == set(want) == {'psnr', 'ssim', 'lpips_rand'}
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert np.isnan(got['lpips_rand']) == (min(h, w) < 31)
    assert isinstance(tmetrics.get_evaluator('zjumocap'), tmetrics.Evaluator)


@pytest.fixture(scope='module')
def avatar():
    ja = JaxAvatar()
    return ja, TorchAvatar(ja)


def test_saved_frames_match_the_jax_path(avatar, tmp_path):
    """The port's frame and composite PNGs decode (with OpenCV) to the
    pixels of the JAX package's PIL path on the same renders; results.npz
    holds the time alone when no metrics are computed."""
    from gsavatar_torch.data import load_dataset
    from gsavatar_torch.inference import InferenceScene
    _, ta = avatar
    scene = InferenceScene(ta.cfg, ta.train.metadata, ta.train.assets,
                           ta.state, device='cpu')
    ds = load_dataset(ta.cfg['dataset'], 'predict', device='cpu')
    cams = [ds[0], ds[1]]
    out = tmp_path / 'torch'
    res = t_eval.evaluate(scene, cams, iteration=ITERATION,
                          keep_renders=True, out_dir=str(out),
                          save_images=True, save_composite=True)
    assert set(np.load(out / 'results.npz').files) == {'metrics/time_ms'}
    jax_dir = tmp_path / 'jax'
    jax_dir.mkdir()
    for cam, img in zip(cams, res['images']):
        # gsavatar/evaluate.py:94-104 on the same image and camera
        arr = (img.numpy() * 255).astype(np.uint8)
        Image.fromarray(arr).save(jax_dir / f'{cam.image_name}.png')
        orig = (np.clip(cam.image.numpy(), 0, 1) * 255).astype(np.uint8)
        Image.fromarray(j_eval.composite_over_original(arr, orig)).save(
            jax_dir / f'{cam.image_name}_composite.png')
        assert 0 < (arr.sum(-1) > 0).mean() < 1
        for name in (f'{cam.image_name}.png',
                     f'{cam.image_name}_composite.png'):
            got = cv2.imread(str(out / name))
            want = cv2.imread(str(jax_dir / name))
            assert got is not None and got.shape == (64, 64, 3)
            np.testing.assert_array_equal(got, want, name)


def test_results_npz_with_metrics(avatar, tmp_path):
    from gsavatar_torch.data import load_dataset
    from gsavatar_torch.inference import InferenceScene
    _, ta = avatar
    scene = InferenceScene(ta.cfg, ta.train.metadata, ta.train.assets,
                           ta.state, device='cpu')
    ds = load_dataset(ta.cfg['dataset'], 'train', device='cpu')
    res = t_eval.evaluate(scene, [ds[0]], out_dir=str(tmp_path),
                          evaluator=tmetrics.PSEvaluator())
    npz = np.load(tmp_path / 'results.npz')
    assert set(npz.files) == {'metrics/psnr', 'metrics/ssim',
                              'metrics/lpips_rand', 'metrics/time_ms'}
    assert float(npz['metrics/psnr']) == res['metrics']['psnr']
    assert not list(tmp_path.glob('*.png'))


SUFFIX_CASES = [
    ['dataset=zjumocap_377_mono', 'mode=test'],
    ['dataset=ps_female_3', 'mode=test', 'dataset.test_mode=pose'],
    ['dataset=zjumocap_377_mono', 'mode=predict', 'dataset.predict_seq=2'],
    ['dataset=zjumocap_377_mono', 'mode=predict', 'dataset.predict_seq=7'],
    ['dataset=ps_male_4', 'mode=predict', 'dataset.predict_seq=1'],
    ['dataset=zjumocap_001_mono', 'mode=predict'],
    ['dataset=zjumocap_377_mono', 'mode=test', 'dataset.freeview=true'],
    ['dataset=zjumocap_377_mono', 'mode=train', 'dataset.freeview=true'],
    ['dataset=synthetic', 'mode=train'],
]


@pytest.mark.parametrize('argv', SUFFIX_CASES,
                         ids=['-'.join(a[1:]) for a in SUFFIX_CASES])
def test_main_suffix_matches_jax(argv, monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(j_eval, 'predict',
                        lambda cfg: seen.setdefault('jax', cfg) and {})
    monkeypatch.setattr(t_eval, 'predict',
                        lambda cfg: seen.setdefault('torch', cfg) and {})
    import gsavatar.utils.jax_cache as jax_cache
    monkeypatch.setattr(jax_cache, 'setup_cache', lambda *a, **k: None)
    argv = argv + [f'exp_dir={tmp_path}']
    j_eval.main(argv)
    t_eval.main(argv)
    assert seen['torch'].get('suffix') == seen['jax'].get('suffix')
    assert seen['torch']['exp_dir'] == seen['jax']['exp_dir']


def test_load_ply_matches_jax(avatar, tmp_path):
    """A ply export of the avatar's arena, loaded by both packages. The
    JAX `load_ply` fills the arena and then raises in `build_converter`
    (its single-npz metadata has no SMPL parameters for the default pose
    correction; ROADMAP §3). The port's arena equals the one JAX filled;
    the port's converter, rebuilt for one frame, is given the weights a
    JAX converter of the same metadata would have, and the two render one
    frame alike."""
    from gsavatar.core import gaussians as JG
    from gsavatar.inference import InferenceScene as JInference
    from gsavatar.models.converter import build_converter as j_build
    from gsavatar.ops.rasterizer import RasterizeConfig
    from gsavatar.renderer import render as j_render
    from gsavatar_torch import convert
    from gsavatar_torch.inference import InferenceScene, torch_generator
    from gsavatar_torch.models.converter import build_converter as t_build
    from gsavatar_torch.utils import ply as tply
    ja, ta = avatar
    path = str(tmp_path / 'arena.ply')
    tply.save_arena_ply(path, ta.state.gauss_params, ta.state.gauss_aux)

    js = JInference(ja.cfg, assets=ja.train.assets)
    with pytest.raises(KeyError, match='root_orient'):
        js.load_ply(path, capacity=1024)
    scene = InferenceScene(ta.cfg, ta.train.metadata, ta.train.assets,
                           ta.state, device='cpu')
    scene.load_ply(path, capacity=1024)
    for f in ('xyz', 'features_dc', 'features_rest', 'scaling', 'rotation',
              'opacity'):
        np.testing.assert_array_equal(
            to_np(getattr(scene.gauss_params, f)),
            np.asarray(getattr(js.gauss_params, f)), f)
    np.testing.assert_array_equal(to_np(scene.gauss_aux.alive),
                                  np.asarray(js.gauss_aux.alive))
    assert scene.metadata['frame_dict'] == {0: 0}
    fresh = t_build(ta.cfg, scene.metadata, ta.train.assets,
                    generator=torch_generator(0)).state_dict()
    for k, v in scene.converter.state_dict().items():
        np.testing.assert_array_equal(to_np(v), to_np(fresh[k]), k)

    md = dict(ja.train.metadata, frame_dict={0: 0})
    conv = j_build(ja.cfg, md, assets=ja.train.assets)
    gview = JG.make_view(js.gauss_params, js.gauss_aux, use_sh=False)
    shapes = jax.eval_shape(lambda: conv.init(
        jax.random.PRNGKey(0), gview, ja.camera, 0))['params']
    params = random_conv_params(shapes, md, seed=5)
    scene.converter.load_state_dict(convert.converter_state(params))
    h, w = ja.cfg.dataset.img_hw
    rc = RasterizeConfig(width=w, height=h, max_pairs=65536, chunk=32,
                         backend='pallas_interpret')
    # the one frame of the rebuilt converter
    jcam = ja.camera.replace(latent_idx=np.int32(0), pose_idx=np.int32(0))
    pkg = j_render(conv, {'params': jax.tree.map(jnp.asarray, params)},
                   gview, jcam, ITERATION, rc, jnp.zeros(3))
    got = scene.render_frame(ta.camera.replace(latent_idx=0, pose_idx=0),
                             ITERATION)
    assert got.n_pairs == int(pkg.n_pairs) > 0
    assert_render_gates(got.render.clamp(0, 1).numpy(),
                        np.asarray(jnp.clip(pkg.render, 0, 1)), 'image')
