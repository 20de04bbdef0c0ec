"""The training driver and the evaluation of gsavatar_torch against
gsavatar's, on the CPU.

One module fixture runs `gsavatar.train.training` and the port's
`training` for 8 iterations of the tiny avatar of tests/test_train_e2e.py
(64x64, 768 Gaussians in 1024 slots) with `model.gaussian.delay=0`, one
validation (iteration 2), a densify (iteration 5) and an opacity reset
(iteration 6) inside the window, and the final checkpoint. The JAX run
takes its pairs route in interpret mode (K1, K2), `rasterizer.auto_size=
false` and `opt.bucket_granularity=0`, so that it keeps one compiled step
at the config's pair and rect ceilings and the whole-arena bucket, as the
port runs. The port starts from the JAX initial state (converter weights,
arena, Adam), sees the JAX ground truth, and takes the JAX step draws
(`torch_parity.jax_draws`, from the JAX state's key) and the JAX split
draws (`PRNGKey(iteration)`).

Tolerances, and why:
* frame picks, the order of steps, validations, densify and reset: equal
  (both draw the frames from `np.random.default_rng(seed)`);
* logged total loss up to the densify: 1e-3 relative, the trajectory gate
  of tests/test_torch_train.py (the images agree to the render gates, and
  Adam's first steps turn gradient signs into +-lr);
* densify counts and `n_alive`: within 1% of the alive count, because the
  statistics differ in f32 rounding and an element near the gradient,
  scale or opacity threshold may fall on the other side;
* validation: l1, SSIM and LPIPS 1e-4 relative, PSNR 1e-3 dB, each
  histogram bin +-1, the point count equal; the saved GT | render |
  5x|error| strips (`save_val_images`; the port writes them with its own
  PNG writer, the JAX driver with Pillow) decoded: the GT panels equal,
  the renders within one grey level, the error panels (5x the render's
  difference) within five;
* the port's `profile_trace_dir` trace of iterations [3, 5) is written;
* the metrics.jsonl keys equal, but for the JAX driver's compile events
  (`compile/*`: the port compiles no step variants);
* a checkpoint loads back bit for bit, and a resumed run continues at the
  next iteration;
* `save_arena_ply` writes the same bytes for the same arena;
* `metrics.Evaluator` and `evaluate` with metrics: 1e-4 relative (the JAX
  package indexes PSNR by its mask as given, which needs a boolean mask:
  its synthetic masks are 0/1 floats, so the JAX side gets them as
  booleans; the port reads any mask as > 0)."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torch_parity import close, jax_draws, to_np

from gsavatar_torch import convert
from gsavatar_torch import train as ttrain
from gsavatar_torch.config import load_config as t_load_config
from gsavatar_torch.data.synthetic import SyntheticDataset as TSynthetic
from gsavatar_torch.evaluate import evaluate as t_evaluate
from gsavatar_torch.evaluate import predict as t_predict
from gsavatar_torch.inference import InferenceScene
from gsavatar_torch.metrics import Evaluator as TEvaluator
from gsavatar_torch.scene import Scene as TScene
from gsavatar_torch.utils import ply as tply

from gsavatar import train as jtrain
from gsavatar.config import load_config as j_load_config
from gsavatar.evaluate import evaluate as j_evaluate
from gsavatar.metrics import Evaluator as JEvaluator
from gsavatar.scene import Scene as JScene
from gsavatar.utils import ply as jply

# tests/test_train_e2e.py:tiny_cfg, without its JAX-only raster keys
TINY = ["dataset.img_hw=[64,64]", "dataset.n_verts=512",
        "dataset.n_points=768", "dataset.n_target_gaussians=512",
        "dataset.train_frames=[0,2,1]", "dataset.train_views=['0']",
        "model.gaussian.capacity=1024", "model.gaussian.delay=0",
        "rasterizer.max_pairs=65536", "opt.skinning_pool_size=2048",
        "opt.n_reg_pts=128"]
JAX_ONLY = ["dataset=synthetic", "rasterizer.per_tile_capacity=1024",
            "rasterizer.chunk=32", "rasterizer.backend=pallas_interpret",
            "rasterizer.auto_size=false"]
ITERATIONS = 8
DENSIFY_AT = 5
DRIVER = [f"opt.iterations={ITERATIONS}", "opt.densify_from_iter=3",
          f"opt.densification_interval={DENSIFY_AT}",
          "opt.opacity_reset_interval=6", "opt.densify_grad_threshold=0.0003",
          "opt.percent_dense=0.005", "opt.opacity_threshold=0.08",
          "test_interval=0", "test_iterations=[2]", "max_val_frames=1",
          "opt.bucket_granularity=0", "checkpoint_iterations=[]",
          "save_iterations=[]", "save_val_images=true"]
# the port's run also writes a torch.profiler trace of iterations [3, 5)
TRACE = (3, 5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _records(exp_dir):
    return [json.loads(line) for line in open(Path(exp_dir) / 'metrics.jsonl')]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('driver')
    jcfg = j_load_config(overrides=JAX_ONLY + TINY + DRIVER
                         + [f"exp_dir={tmp / 'jax'}"])
    tcfg = t_load_config(TINY + DRIVER + [
        f"exp_dir={tmp / 'torch'}", f"profile_trace_dir={tmp / 'trace'}",
        f"profile_start_iter={TRACE[0]}", f"profile_stop_iter={TRACE[1]}"])
    js = JScene(jcfg, seed=0)
    j0 = _np(js.init_state())
    ts = TScene(tcfg, seed=0, device='cpu')
    state0 = ts.init_state()
    ts.converter.load_state_dict(convert.converter_state(
        j0.conv_params['params']))
    state0.gauss_params, state0.gauss_aux = convert.arena(j0.gauss_params,
                                                          j0.gauss_aux)
    state0.gauss_adam = convert.arena_adam(j0.gauss_adam)
    ts.init_state = lambda: state0

    gt = {}
    for ds in (js.train_dataset, js.test_dataset):
        for i in range(len(ds)):
            c = ds[i]
            gt[c.image_name] = (np.array(c.image), np.array(c.mask))
    events = {'jax': [], 'torch': []}

    def camera_log(name, fn):
        def device_camera(idx, split='train'):
            events[name].append(('camera', idx, split))
            return fn(idx, split)
        return device_camera

    js.device_camera = camera_log('jax', js.device_camera)
    ts.device_camera = camera_log('torch', ts.device_camera)
    make_densify = jtrain.make_densify_step

    def j_make_densify_step(scene):
        densify, reset, knn = make_densify(scene)

        def j_densify(state, key, use_ss):
            events['jax'].append(('densify', bool(use_ss)))
            return densify(state, key, use_ss)

        def j_reset(state):
            events['jax'].append(('reset',))
            return reset(state)
        return j_densify, j_reset, knn

    t_densify, t_reset = ttrain.densify_step, ttrain.opacity_reset_step

    def t_densify_step(scene, state, eps1, eps2, use_ss):
        events['torch'].append(('densify', bool(use_ss)))
        return t_densify(scene, state, eps1, eps2, use_ss)

    def t_reset_step(state):
        events['torch'].append(('reset',))
        return t_reset(state)

    key = [j0.rng]
    rots_shape = tuple(js.train_dataset[0].rots.shape)

    def draw(scene, generator):
        key[0], (d,) = jax_draws(key[0], rots_shape, scene.n_reg_pts,
                                 int(scene.skinning_pool_pts.shape[0]),
                                 scene.converter.pose_noise,
                                 scene.converter.view_noise)
        return d

    def densify_draws(state, iteration):
        k1, k2 = jax.random.split(jax.random.PRNGKey(iteration))
        n = state.gauss_params.xyz.shape[0]
        return tuple(torch.from_numpy(np.array(jax.random.normal(k, (n, 3))))
                     for k in (k1, k2))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, 'make_densify_step', j_make_densify_step)
        mp.setattr(ttrain, 'densify_step', t_densify_step)
        mp.setattr(ttrain, 'opacity_reset_step', t_reset_step)
        mp.setattr(ttrain, 'draw', draw)
        mp.setattr(ttrain, 'densify_draws', densify_draws)
        mp.setattr(TSynthetic, 'render_gt', lambda self, cam, dev: tuple(
            torch.from_numpy(a).to(dev) for a in gt[cam.image_name]))
        _, jstate, _ = jtrain.training(jcfg, scene=js, log_every=1,
                                       progress=False)
        _, tstate, _ = ttrain.training(tcfg, scene=ts, log_every=1,
                                       progress=False)
    return {'tmp': tmp, 'jcfg': jcfg, 'tcfg': tcfg, 'js': js, 'ts': ts,
            'jstate': jstate, 'tstate': tstate, 'events': events,
            'jrec': _records(tmp / 'jax'), 'trec': _records(tmp / 'torch')}


def _by_step(records, prefix):
    return {r['step']: r for r in records if any(k.startswith(prefix)
                                                 for k in r)}


def test_frames_and_schedule_events_match(runs):
    ev = runs['events']
    assert ev['torch'] == ev['jax']
    picks = [e for e in ev['jax'] if e[0] == 'camera']
    assert len(picks) == ITERATIONS + 2      # the validation's two frames
    assert ('densify', False) in ev['jax'] and ('reset',) in ev['jax']


def test_losses_match_until_the_first_densify(runs):
    j = _by_step(runs['jrec'], 'loss/total_loss')
    t = _by_step(runs['trec'], 'loss/total_loss')
    assert sorted(j) == sorted(t) == list(range(1, ITERATIONS + 1))
    for s in range(1, DENSIFY_AT + 1):
        close(t[s]['loss/total_loss'], j[s]['loss/total_loss'], 1e-3, 0,
              f'iteration {s}')
        assert t[s]['overflow/pairs'] == j[s]['overflow/pairs'] == 0
        assert t[s]['overflow/rect'] == j[s]['overflow/rect'] == 0


def test_densify_counts_match(runs):
    j = _by_step(runs['jrec'], 'densify/')
    t = _by_step(runs['trec'], 'densify/')
    assert sorted(j) == sorted(t) == [DENSIFY_AT]
    j, t = j[DENSIFY_AT], t[DENSIFY_AT]
    for k in ('n_cloned', 'n_split', 'n_pruned', 'n_dropped', 'n_alive'):
        assert abs(t[f'densify/{k}'] - j[f'densify/{k}']) \
            <= 0.01 * j['densify/n_alive'], k
    assert j['densify/n_cloned'] > 0 and j['densify/n_split'] > 0
    assert j['densify/n_pruned'] > 0
    n = int(runs['tstate'].gauss_aux.alive.sum())
    assert bool(runs['tstate'].gauss_aux.alive[:n].all())
    assert n == t['densify/n_alive']


def test_validation_metrics_match(runs):
    j = _by_step(runs['jrec'], 'val/')
    t = _by_step(runs['trec'], 'val/')
    assert sorted(j) == sorted(t) == [2]
    j, t = j[2], t[2]
    assert set(t) == set(j)
    for k in j:
        if k.endswith('_psnr'):
            assert abs(t[k] - j[k]) <= 1e-3, k
        elif k.endswith(('_l1_loss', '_ssim', '_lpips_rand', '_lpips')):
            close(t[k], j[k], 1e-4, 0, k)
    assert np.abs(np.subtract(t['val/opacity_histogram'],
                              j['val/opacity_histogram'])).max() <= 1
    assert t['val/total_points'] == j['val/total_points']


def test_metrics_jsonl_keys_match(runs):
    keys = lambda recs: {k for r in recs for k in r
                         if not k.startswith('compile/')}
    assert keys(runs['trec']) == keys(runs['jrec'])
    assert runs['trec'][0]['lpips_weights'] == \
        runs['jrec'][0]['lpips_weights'] == 'random'


def _same(a, b, name):
    assert a.dtype == b.dtype and torch.equal(a, b), name


def test_checkpoint_round_trip_and_resume(runs, tmp_path):
    ts, tstate = runs['ts'], runs['tstate']
    path = runs['tmp'] / 'torch' / f'ckpt{ITERATIONS}.pt'
    state, it = ts.load_checkpoint(str(path))
    assert it == ITERATIONS
    for part in ('gauss_params', 'gauss_aux'):
        for f, v in vars(getattr(state, part)).items():
            _same(v, getattr(getattr(tstate, part), f), f'{part}.{f}')
    for which in ('m', 'v'):
        for f, v in vars(getattr(state.gauss_adam, which)).items():
            _same(v, getattr(getattr(tstate.gauss_adam, which), f), f)
    assert state.gauss_adam.step == tstate.gauss_adam.step > 0
    for k, v in state.conv_params.items():
        _same(v.detach(), tstate.conv_params[k].detach(), k)
    for k in tstate.conv_opt.mu:
        _same(state.conv_opt.mu[k], tstate.conv_opt.mu[k], k)
        _same(state.conv_opt.nu[k], tstate.conv_opt.nu[k], k)
    assert state.conv_opt.count == tstate.conv_opt.count == ITERATIONS
    assert torch.equal(state.generator.get_state(),
                       tstate.generator.get_state())

    cfg = t_load_config(TINY + DRIVER + [f"exp_dir={tmp_path}",
                                         f"start_checkpoint={path}"])
    _, resumed, logger = ttrain.training(cfg, max_iterations=ITERATIONS + 1,
                                         log_every=1, progress=False,
                                         device='cpu')
    steps = [r['step'] for r in logger.history if 'loss/total_loss' in r]
    assert steps == [ITERATIONS + 1]
    assert resumed.conv_opt.count == ITERATIONS + 1
    assert (tmp_path / f'ckpt{ITERATIONS + 1}.pt').exists()


def test_missing_checkpoint_field_raises(runs, tmp_path):
    ckpt = torch.load(runs['tmp'] / 'torch' / f'ckpt{ITERATIONS}.pt',
                      weights_only=True)
    del ckpt['conv_opt']
    torch.save(ckpt, tmp_path / 'old.pt')
    with pytest.raises(ValueError, match='conv_opt'):
        runs['ts'].load_checkpoint(str(tmp_path / 'old.pt'))


def test_save_arena_ply_writes_the_same_bytes(runs, tmp_path):
    j = _np(runs['jstate'])
    jply.save_arena_ply(str(tmp_path / 'j.ply'), j.gauss_params, j.gauss_aux)
    params, aux = convert.arena(j.gauss_params, j.gauss_aux)
    tply.save_arena_ply(str(tmp_path / 't.ply'), params, aux)
    assert (tmp_path / 't.ply').read_bytes() == \
        (tmp_path / 'j.ply').read_bytes()
    back = tply.load_gaussian_ply(str(tmp_path / 't.ply'))
    alive = to_np(aux.alive)
    for f in ('xyz', 'features_dc', 'features_rest', 'opacity', 'scaling',
              'rotation'):
        assert np.array_equal(back[f], to_np(getattr(params, f))[alive]), f


def test_evaluator_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.random((96, 80, 3)).astype(np.float32)
    gt = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(
        np.float32)
    mask = np.zeros((96, 80), np.float32)
    mask[10:70, 20:61] = 1.0
    for m in (None, mask):
        want = JEvaluator()(img, gt, valid_mask=None if m is None else m > 0)
        got = TEvaluator()(torch.from_numpy(img), torch.from_numpy(gt),
                           valid_mask=None if m is None
                           else torch.from_numpy(m))
        assert set(got) == set(want) == {'psnr', 'ssim', 'lpips_rand'}
        for k in want:
            close(got[k], want[k], 1e-4, 0, k)


class _BoolMasks:
    """A JAX dataset whose cameras carry their masks as booleans."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        c = self.ds[i]
        return c.replace(mask=np.asarray(c.mask) > 0)


def _port_checkpoint(runs, path_dir):
    """The JAX run's final state as a checkpoint of the port."""
    j = _np(runs['jstate'])
    scene = TScene(runs['tcfg'], seed=0, device='cpu')
    state = scene.init_state()
    scene.converter.load_state_dict(convert.converter_state(
        j.conv_params['params']))
    state.gauss_params, state.gauss_aux = convert.arena(j.gauss_params,
                                                        j.gauss_aux)
    state.gauss_adam = convert.arena_adam(j.gauss_adam)
    return scene.save_checkpoint(state, ITERATIONS, str(path_dir))


def test_evaluate_with_metrics_matches_jax(runs, tmp_path):
    """Both packages evaluate the JAX run's final state on the training
    cameras (the validation camera's mask box is narrower than LPIPS's 16
    pixels, where both report NaN) and write results.npz."""
    js = runs['js']
    js.test_dataset = _BoolMasks(js.train_dataset)
    js._cam_cache = {}
    (tmp_path / 'jax').mkdir()     # the JAX evaluate makes it only for images
    j_evaluate(runs['jcfg'], js, runs['jstate'], ITERATIONS,
               out_dir=str(tmp_path / 'jax'), save_images=False)
    scene = InferenceScene.from_checkpoint(
        runs['tcfg'], _port_checkpoint(runs, tmp_path / 'ckpt'),
        device='cpu')
    assert scene.iteration == ITERATIONS
    ds = runs['ts'].train_dataset        # cached with the JAX ground truth
    got = t_evaluate(scene, [ds[i] for i in range(len(ds))],
                     iteration=scene.iteration, evaluator=TEvaluator(),
                     out_dir=str(tmp_path / 'torch'))
    assert max(got['pair_overflow']) == 0
    j_npz = np.load(tmp_path / 'jax' / 'results.npz')
    t_npz = np.load(tmp_path / 'torch' / 'results.npz')
    assert set(t_npz.files) == set(j_npz.files)
    for k in j_npz.files:
        if k != 'metrics/time_ms':
            assert np.isfinite(j_npz[k]), k
            close(t_npz[k], j_npz[k], 1e-4, 0, k)


def test_predict_scores_a_port_checkpoint(runs, tmp_path):
    path = _port_checkpoint(runs, tmp_path / 'ckpt')
    cfg = t_load_config(TINY + DRIVER + ["mode=test", f"load_ckpt={path}",
                                         f"exp_dir={tmp_path}"])
    res = t_predict(cfg, device='cpu')
    npz = np.load(tmp_path / 'eval_view' / 'results.npz')
    assert set(npz.files) == {'metrics/psnr', 'metrics/ssim',
                              'metrics/lpips_rand', 'metrics/time_ms'}
    assert np.isfinite(res['psnr']) and 0 < res['ssim'] <= 1
    assert float(npz['metrics/psnr']) == res['psnr']
    # the test camera's mask box is 11 pixels wide: LPIPS is NaN, as the
    # JAX package's is on it
    assert np.isnan(res['lpips_rand'])
    cfg = t_load_config(TINY + DRIVER + ["mode=predict", f"load_ckpt={path}",
                                         f"exp_dir={tmp_path / 'p'}"])
    assert set(t_predict(cfg, device='cpu')) == {'time_ms'}


def test_validation_strips_match_jax(runs):
    from gsavatar_torch.utils import png
    jdir = runs['tmp'] / 'jax' / 'validation' / 'iter_2'
    tdir = runs['tmp'] / 'torch' / 'validation' / 'iter_2'
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    assert len(names) == 2                 # test_ and train_, one frame each
    for name in names:
        want = png.read_png(str(jdir / name)).astype(np.int32)
        got = png.read_png(str(tdir / name)).astype(np.int32)
        assert got.shape == want.shape == (64, 3 * 64, 3)
        # the ground-truth panel is the same frame in both; the renders
        # within one grey level; the error panel is 5x the render's
        # difference, so within 5
        np.testing.assert_array_equal(got[:, :64], want[:, :64])
        assert np.abs(got[:, 64:128] - want[:, 64:128]).max() <= 1, name
        assert np.abs(got[:, 128:] - want[:, 128:]).max() <= 5, name


def test_profile_trace_is_written(runs):
    trace = runs['tmp'] / 'trace' / f'trace_{TRACE[0]}_{TRACE[1]}.json'
    events = json.loads(trace.read_text())['traceEvents']
    names = {e.get('name', '') for e in events}
    # the traced iterations' steps: the compositor and the segment sums
    assert any('aten::' in n for n in names)
    assert len(events) > 100


def test_trace_window_starts_and_stops(tmp_path):
    """`TraceWindow` starts at its first iteration, writes at its last
    (exclusive), once; a run that ends inside the window writes it then;
    without a directory it does nothing."""
    w = ttrain.TraceWindow(str(tmp_path / 'a'), 2, 4, 'cpu')
    for it in range(1, 7):
        w.at(it)
        torch.ones(8).sum()
        assert (w.prof is not None) == (2 <= it < 4)
    assert w.path == str(tmp_path / 'a' / 'trace_2_4.json')
    assert Path(w.path).exists()
    w = ttrain.TraceWindow(str(tmp_path / 'b'), 5, 9, 'cpu')
    for it in range(1, 7):
        w.at(it)
    w.at(9)                                   # the run's end
    assert Path(tmp_path / 'b' / 'trace_5_9.json').exists()
    w = ttrain.TraceWindow(None, 1, 3, 'cpu')
    for it in range(1, 5):
        w.at(it)
    assert w.path is None and not list(tmp_path.glob('c*'))


# six iterations with a densify at 4 and an opacity reset at 5
LOOP = ["opt.iterations=6", "opt.densify_from_iter=3",
        "opt.densification_interval=4", "opt.opacity_reset_interval=5",
        "opt.densify_grad_threshold=0.0003", "opt.percent_dense=0.005",
        "opt.opacity_threshold=0.08", "test_interval=0",
        "checkpoint_iterations=[]", "save_iterations=[]", "seed=0"]


def test_train_loop_by_hand_equals_training(tmp_path):
    """`train.TrainLoop` driven by hand (a frame, `step`, then
    `after_step`) gives `training`'s logged losses, densify counts and
    final state bit for bit."""
    from gsavatar_torch.parallel.shard import state_tensors
    cfg = t_load_config(TINY + LOOP + [f"exp_dir={tmp_path}"])
    _, want, logger = ttrain.training(cfg, log_every=1, progress=False,
                                      device='cpu')
    scene = TScene(cfg, seed=0, device='cpu')
    loop = ttrain.TrainLoop(cfg, scene, scene.init_state(),
                            ttrain.make_train_step(scene), seed=0)
    losses, alive = {}, {}
    for it in range(1, 7):
        metrics = loop.step(it, scene.device_camera(loop.next_frame()))
        losses[it] = ttrain.host_metrics(metrics)['loss/total_loss']
        counts = loop.after_step(it)
        if counts:
            alive[it] = counts['n_alive']
    rows = lambda key: {r['step']: r[key] for r in logger.history if key in r}
    assert losses == rows('loss/total_loss')
    assert alive == rows('densify/n_alive') and list(alive) == [4]
    got, ref = state_tensors(loop.state), state_tensors(want)
    assert set(got) == set(ref)
    for k in ref:
        _same(got[k], ref[k], k)
    assert torch.equal(loop.state.generator.get_state(),
                       want.generator.get_state())
