"""The serving path of the port against the JAX package's: the scene of a
checkpoint and an SMPL npz (`InferenceScene.from_smpl_npz`,
`metadata_from_smpl_npz`) and the four apps (`gsavatar_torch/apps/`),
each on a tiny avatar (64^2, 768 Gaussians, the 6890-vertex synthetic body
the ZJU-MoCap loaders read) whose weights and arena both packages hold:
the JAX scene from an orbax checkpoint, the port's from its own checkpoint
file, the weights carried over with `gsavatar_torch/convert.py`. The JAX
package runs its own CPU route (`rasterizer.backend` auto: the XLA route),
its apps with OpenCV and Pillow.

Tolerances: renders, PNG frames and composites (as /255) within bench.py's
render gates (`torch_parity.assert_render_gates`); the port's composite of
the JAX render equal to the JAX composite (the float resize and the
composite are exact); metadata equal (delta 0); `cam_params.json` equal;
the model npz's parameters equal and its bone transforms within 1e-5 (the
two packages' LBS); the capture tree read by the JAX and the port ZJU-MoCap
loaders equal (delta 0).

Reference faults these tests assert (ROADMAP §3): the JAX npz route raises
`KeyError: 'root_orient'` under the default `pose_correction=direct`
(its JAX scene here gets the pose keys added to its metadata); the JAX
`capture_and_record` parses each frame twice, so in accumulate mode its
npz's `trans` is one delta behind the pose it rendered; the ZJU-MoCap
loaders take a capture's frames as 1024^2 (`RAW_HW`), so a 64^2 capture's
cameras come back with 1/16 of its focal length."""
import dataclasses
import json

import cv2
import numpy as np
import pytest
import torch

from torch_parity import (JaxAvatar, TorchAvatar, assert_render_gates,
                          motion_arrays, smooth_frame, to_np,
                          write_torch_checkpoint)

from gsavatar_torch import native
from gsavatar_torch.apps import ar_render as t_ar
from gsavatar_torch.apps import body_replace as t_body
from gsavatar_torch.apps import capture_and_record as t_capture
from gsavatar_torch.apps import render_series as t_series_app
from gsavatar_torch.camera.live import live_camera as t_live
from gsavatar_torch.config import load_config as t_load_config
from gsavatar_torch.data import load_dataset as t_load_dataset
from gsavatar_torch.evaluate import to_uint8
from gsavatar_torch.inference import InferenceScene, metadata_from_smpl_npz
from gsavatar_torch.motion import streams as t_streams
from gsavatar_torch.motion.series import MotionSeries as TSeries
from gsavatar_torch.utils import png

from gsavatar.apps import ar_render as j_ar
from gsavatar.apps import body_replace as j_body
from gsavatar.apps import capture_and_record as j_capture
from gsavatar.apps import render_series as j_series_app
from gsavatar.camera.live import live_camera as j_live
from gsavatar.config import load_config as j_load_config
from gsavatar.data import load_dataset as j_load_dataset
from gsavatar.inference import InferenceScene as JInference
from gsavatar.inference import metadata_from_smpl_npz as j_metadata
from gsavatar.motion.series import MotionSeries as JSeries

# the synthetic body the ZJU-MoCap loaders use (`find_assets(None)`)
BODY = ['dataset.n_verts=6890']
FRAMES = 3
HW = 64
POSE_KEYS = ('root_orient', 'pose_body', 'pose_hand', 'trans', 'betas')


def _orbax(path, ja):
    """The checkpoint that the JAX `InferenceScene.load_checkpoint` reads:
    the arena and the converter's variables."""
    import orbax.checkpoint as ocp
    tree = lambda s: {f.name: np.asarray(getattr(s, f.name))
                      for f in dataclasses.fields(s)}
    ocp.PyTreeCheckpointer().save(str(path), {
        'gauss_params': tree(ja.gauss_params),
        'gauss_aux': tree(ja.gauss_aux),
        'conv_params': {'params': ja.params}})
    return str(path)


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    ja = JaxAvatar(overrides=BODY)
    ta = TorchAvatar(ja, overrides=BODY)
    root = tmp_path_factory.mktemp('served')
    npz = str(root / 'smpl.npz')
    np.savez(npz, minimal_shape=ta.train.assets.v_template)
    ckpt = write_torch_checkpoint(root / 'ckpt.pt', ta.state, 15000)
    ojax = _orbax(root / 'orbax', ja)
    js = JInference(ja.cfg, smpl_npz=npz, assets=ja.train.assets)
    js.metadata.update({k: ja.train.metadata[k] for k in POSE_KEYS})
    js.load_checkpoint(ojax)
    ts = InferenceScene.from_smpl_npz(ta.cfg, ckpt, npz,
                                      assets=ta.train.assets, device='cpu')
    return {'ja': ja, 'ta': ta, 'js': js, 'ts': ts, 'npz': npz,
            'ckpt': ckpt, 'orbax': ojax}


def _series(served, seed, global_z, **kw):
    arrays = motion_arrays(FRAMES, seed=seed, global_z=global_z)
    return (JSeries(arrays, served['ja'].train.assets, **kw),
            TSeries(arrays, served['ta'].train.assets, device='cpu', **kw))


def _gates(got, want, name):
    assert_render_gates(np.asarray(got, np.float64) / 255.0,
                        np.asarray(want, np.float64) / 255.0, name)


def test_jax_npz_route_raises_under_direct(served):
    js = JInference(served['ja'].cfg, smpl_npz=served['npz'],
                    assets=served['ja'].train.assets)
    with pytest.raises(KeyError, match='root_orient'):
        js.load_checkpoint(served['orbax'])


@pytest.mark.parametrize('with_npz', [True, False], ids=['npz', 'template'])
def test_metadata_from_smpl_npz_matches_jax(served, with_npz):
    ja, ta = served['ja'], served['ta']
    path = served['npz'] if with_npz else None
    want = j_metadata(path, ja.train.assets)
    got = metadata_from_smpl_npz(path, ta.train.assets)
    assert sorted(got) == sorted(want)
    for k in got:
        if k == 'aabb':
            for f in ('coord_min', 'coord_max'):
                np.testing.assert_array_equal(to_np(getattr(got[k], f)),
                                              np.asarray(getattr(want[k], f)))
        elif isinstance(got[k], np.ndarray):
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
        else:
            assert got[k] == want[k], k


def test_npz_scene_sizes_from_the_checkpoint(served):
    ts, ta = served['ts'], served['ta']
    assert ts.metadata['frame_dict'] == served['js'].metadata['frame_dict'] \
        == {0: 0, 1: 1}
    assert ts.iteration == int(ta.cfg['opt']['iterations'])
    assert ts.raster_config.width == ts.raster_config.height == HW
    assert not ts.background.any()
    for k, v in ts.converter.state_dict().items():
        if k in ta.state.converter:
            assert torch.equal(v, ta.state.converter[k]), k


def test_npz_route_renders_as_jax(served):
    rots, Jtrs, bt = _series(served, 0, 0.0)[1].camera_pose_fields(
        1, served['ts'].metadata)
    R, T = np.eye(3, dtype=np.float32), np.array([0, 0, 2.5], np.float32)
    want = served['js'].render_frame(j_live(
        R, T, width=HW, height=HW, rots=rots, Jtrs=Jtrs, bone_transforms=bt))
    got = served['ts'].render_frame(t_live(
        R, T, width=HW, height=HW, rots=rots, Jtrs=Jtrs, bone_transforms=bt,
        device='cpu'))
    assert float(got.opacity_render.mean()) > 0.01
    assert_render_gates(got.render.clamp(0, 1).numpy(),
                        np.clip(np.asarray(want.render), 0, 1), 'image')
    assert_render_gates(got.opacity_render.numpy(),
                        np.asarray(want.opacity_render), 'alpha')


def test_npz_route_equals_checkpoint_route(served):
    """Same arena, same weights, a live camera (in_frame_dict 0): the npz
    scene's render equals, bit for bit, that of the scene built from the
    training subject's metadata."""
    ta, ts = served['ta'], served['ts']
    ref = InferenceScene(ta.cfg, ta.train.metadata, ta.train.assets,
                         ta.state, device='cpu')
    rots, Jtrs, bt = _series(served, 1, 0.0)[1].camera_pose_fields(
        0, ts.metadata)
    cam = t_live(np.eye(3), np.array([0, 0, 2.5]), width=HW, height=HW,
                 rots=rots, Jtrs=Jtrs, bone_transforms=bt, device='cpu')
    a, b = ts.render_frame(cam), ref.render_frame(cam)
    assert torch.equal(a.render, b.render)
    assert torch.equal(a.opacity_render, b.opacity_render)


def test_sh_texture_checkpoint_with_pose_tables_loads(tmp_path):
    """texture=sh: the checkpoint has no texture latent (frame_dict gets
    one row) while the pose tables and the non-rigid deformer's latent
    keep the training frames' rows; the port loads them with their own
    rows and renders."""
    from gsavatar_torch.data.synthetic import SyntheticDataset
    from gsavatar_torch.inference import init_state
    cfg = t_load_config(["dataset.img_hw=[32,32]", "dataset.n_verts=512",
                         "dataset.n_points=256", "dataset.train_frames=[0,3,1]",
                         "model.gaussian.capacity=512", "texture=sh",
                         "model.deformer.non_rigid.latent_dim=4"])
    train = SyntheticDataset(cfg['dataset'], 'train')
    state = init_state(cfg, train, seed=1, device='cpu')
    assert state.converter['pose_correction.root_orients'].shape[0] == 3
    assert state.converter['non_rigid.latent.weight'].shape == (3, 4)
    assert 'texture.latent.weight' not in state.converter
    path = write_torch_checkpoint(tmp_path / 'sh.pt', state, 100)
    scene = InferenceScene.from_smpl_npz(cfg, path, assets=train.assets,
                                         device='cpu')
    assert scene.metadata['frame_dict'] == {0: 0}
    got = scene.converter.state_dict()
    for k, v in state.converter.items():
        assert torch.equal(got[k], v), k
    pkg = scene.render_frame(t_live(np.eye(3), [0, 0, 2.5], width=32,
                                    height=32, device='cpu'))
    assert bool(pkg.render.isfinite().all())


def test_render_series_matches_jax(served, tmp_path):
    jser, tser = _series(served, 2, 0.0)
    want = j_series_app.render_series(served['js'], jser,
                                      out_dir=str(tmp_path / 'jax'),
                                      width=HW, height=HW, save_video=False)
    got = t_series_app.render_series(served['ts'], tser,
                                     out_dir=str(tmp_path / 'torch'),
                                     width=HW, height=HW, save_video=False)
    assert len(got) == len(want) == FRAMES
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.uint8 and g.shape == w.shape == (HW, HW, 3)
        assert (g.sum(-1) > 0).mean() > 0.01
        _gates(g, w, f'frame {i}')
        path = str(tmp_path / 'torch' / f'{i:06d}.png')
        np.testing.assert_array_equal(
            cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), g)
        np.testing.assert_array_equal(png.read_png(path), g)


def _composite_checks(got, want, frames, js, jser, make_camera):
    """Port against JAX composites, then the port's resize and composite
    of the JAX render against the JAX composite, bit for bit."""
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.uint8 and g.shape == w.shape == frames[i].shape
        _gates(g, w, f'composite {i}')
    rots, Jtrs, bt = jser.camera_pose_fields(0, js.metadata)
    pkg = js.render_frame(make_camera(rots, Jtrs, bt))
    again = t_body.composite_frame(
        torch.from_numpy(np.array(pkg.render)),
        torch.from_numpy(np.array(pkg.opacity_render)),
        torch.from_numpy(frames[0])).numpy()
    np.testing.assert_array_equal(again, want[0])
    assert (again != frames[0]).any(axis=-1).mean() > 0.01


def test_body_replace_matches_jax(served, tmp_path):
    jser, tser = _series(served, 3, 3.0)
    frames = [smooth_frame(96, 80, 10 + i) for i in range(FRAMES)]
    want = j_body.body_replace(served['js'], jser, frames,
                               out_dir=str(tmp_path / 'jax'),
                               save_video=False)
    got = t_body.body_replace(served['ts'], tser, frames,
                              out_dir=str(tmp_path / 'torch'),
                              save_video=False)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(
            png.read_png(str(tmp_path / 'torch' / f'{i:06d}.png')), g)
    K = j_body.series_K(jser, 80, 96)
    np.testing.assert_array_equal(t_body.series_K(tser, 80, 96), K)
    _composite_checks(got, want, frames, served['js'], jser,
                      lambda r, J, b: j_live(
                          np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                          K=K, width=HW, height=HW, rots=r, Jtrs=J,
                          bone_transforms=b))


def _board_feed(n):
    """Seeded webcam frames and board poses (R, T) as cv2 gives them
    (float64), one frame without a pose."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        R = Rotation.from_rotvec(0.1 * rng.standard_normal(3)).as_matrix()
        T = np.array([0.0, 0.0, 0.02]) + 0.01 * rng.standard_normal(3)
        out.append((smooth_frame(72, 88, 20 + i), None if i == 1 else (R, T)))
    return out


class _FakeCamera:
    K = np.array([[900.0, 0, 44.0], [0, 900.0, 36.0], [0, 0, 1]], np.float32)

    def __init__(self, device=0, **kw):
        self.released = False

    def release(self):
        self.released = True


def _fake_board(feed):
    class Board:
        def __init__(self, source, K):
            self.source = source

        def __iter__(self):
            return iter(feed)
    return Board


def test_ar_loop_matches_jax(served, monkeypatch):
    feed = _board_feed(FRAMES + 1)
    shown = []
    monkeypatch.setattr(j_ar, 'CameraStream', _FakeCamera)
    monkeypatch.setattr(j_ar, 'ChArucoStream', _fake_board(feed))
    monkeypatch.setattr(cv2, 'imshow', lambda name, img: shown.append(
        cv2.cvtColor(img, cv2.COLOR_BGR2RGB)))
    monkeypatch.setattr(cv2, 'waitKey', lambda ms: -1)
    jser, tser = _series(served, 4, 3.0)
    j_ar.ar_render(served['js'], jser, max_frames=FRAMES, display=True)
    want = list(shown)
    got = list(t_ar.ar_loop(served['ts'], tser, feed, _FakeCamera.K,
                            max_frames=FRAMES))
    assert len(got) == len(want) == FRAMES
    frames = [f for f, pose in feed if pose is not None]
    R, T = feed[0][1]
    _composite_checks(got, want, frames, served['js'], jser,
                      lambda r, J, b: j_live(
                          R.T.astype(np.float32),
                          (4.0 * T).astype(np.float32), K=_FakeCamera.K,
                          width=HW, height=HW, rots=r, Jtrs=J,
                          bone_transforms=b))

    # the port's ar_render: its streams and its display
    shown.clear()
    cams = []
    monkeypatch.setattr(t_streams, 'CameraStream',
                        lambda device=0: cams.append(_FakeCamera()) or cams[-1])
    monkeypatch.setattr(t_streams, 'ChArucoStream', _fake_board(feed))
    t_ar.ar_render(served['ts'], _series(served, 4, 3.0)[1],
                   max_frames=FRAMES, display=True)
    assert cams[0].released and len(shown) == FRAMES
    for a, b in zip(shown, got):
        np.testing.assert_array_equal(a, b)


def _zju_config(root, subject, load_config):
    return load_config([
        'dataset=zjumocap_377_mono', f'dataset.root_dir={root}',
        f'dataset.subject={subject}', "dataset.train_views=['1']",
        f'dataset.train_frames=[0,{FRAMES},1]',
        f'dataset.img_hw=[{HW},{HW}]'])


def test_capture_and_record_matches_jax(served, tmp_path, monkeypatch):
    import gsavatar.native
    monkeypatch.setattr(gsavatar.native, 'available', lambda: False)
    jser, tser = _series(served, 5, 0.0)
    jdir, tdir = tmp_path / 'J1', tmp_path / 'T1'
    j_capture.capture_and_record(served['js'], jser, out_dir=str(jdir),
                                 width=HW, height=HW)
    t_capture.capture_and_record(served['ts'], tser, out_dir=str(tdir),
                                 width=HW, height=HW)
    with open(jdir / 'cam_params.json') as f:
        jcam = json.load(f)
    with open(tdir / 'cam_params.json') as f:
        tcam = json.load(f)
    assert tcam == jcam
    for i in range(FRAMES):
        a = np.load(tdir / 'models' / f'{i:06d}.npz')
        b = np.load(jdir / 'models' / f'{i:06d}.npz')
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k == 'bone_transforms':
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(a[k], b[k], k)
        name = f'{i:06d}'
        jimg = cv2.cvtColor(cv2.imread(str(jdir / '1' / f'{name}.jpg')),
                            cv2.COLOR_BGR2RGB)
        timg = native.read_jpeg(str(tdir / '1' / f'{name}.jpg'))
        _gates(timg, jimg, f'jpeg {i}')
        jmask = cv2.imread(str(jdir / '1' / f'{name}.png'),
                           cv2.IMREAD_GRAYSCALE)
        tmask = png.read_png(str(tdir / '1' / f'{name}.png'), 'gray')
        assert set(np.unique(tmask)) <= {0, 255} and (tmask > 0).mean() > 0.01
        _gates(tmask, jmask, f'mask {i}')
        # the JPEG holds the bytes cv2 writes for the frame rendered
        rots, Jtrs, bt = tser.camera_pose_fields(i, served['ts'].metadata,
                                                 tser.parse(i))
        img = to_uint8(served['ts'].render_frame(t_live(
            np.eye(3), np.array([0, 0, 2.5], np.float32), width=HW,
            height=HW, rots=rots, Jtrs=Jtrs, bone_transforms=bt,
            device='cpu')).render.clamp(0, 1))
        ok, want = cv2.imencode('.jpg', cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        assert (tdir / '1' / f'{name}.jpg').read_bytes() == want.tobytes()

    # the port's tree through both ZJU-MoCap loaders: the same frames
    jds = j_load_dataset(_zju_config(tmp_path, 'T1', lambda o: j_load_config(
        overrides=o)).dataset, 'train')
    tds = t_load_dataset(_zju_config(tmp_path, 'T1', t_load_config)['dataset'],
                         'train', device='cpu')
    assert len(tds) == len(jds) == FRAMES
    for i in range(FRAMES):
        j, t = jds[i], tds[i]
        np.testing.assert_array_equal(to_np(t.image), np.asarray(j.image))
        np.testing.assert_array_equal(to_np(t.mask), np.asarray(j.mask))
        np.testing.assert_allclose(to_np(t.bone_transforms),
                                   np.asarray(j.bone_transforms), rtol=1e-6,
                                   atol=1e-6)
        # the loaders take the frames as 1024^2 (RAW_HW): the camera comes
        # back with HW / 1024 of the capture's focal length
        f_capture = tcam['1']['K'][0][0]
        for cam in (j, t):
            f_loaded = HW / (2 * np.tan(cam.fovx / 2))
            np.testing.assert_allclose(f_loaded, f_capture * HW / 1024,
                                       rtol=1e-6)


def test_capture_parses_each_frame_once(served, tmp_path):
    """Accumulate mode: the JAX app parses each frame twice, so frame i's
    npz holds global_t + (2i + 1) delta while its camera was posed at
    (2i + 2) delta; the port's npz holds global_t + (i + 1) delta, the
    translation it rendered."""
    delta = np.array([0.02, 0.0, -0.01], np.float32)
    jser, tser = _series(served, 6, 0.0, accumulate=True, trans_delta=delta)
    j_capture.capture_and_record(served['js'], jser, out_dir=str(tmp_path /
                                                                 'J'),
                                 width=HW, height=HW)
    seen = []
    fields = tser.camera_pose_fields
    tser.camera_pose_fields = lambda i, md, p=None: seen.append(p) or \
        fields(i, md, p)
    t_capture.capture_and_record(served['ts'], tser,
                                 out_dir=str(tmp_path / 'T'), width=HW,
                                 height=HW)
    g = motion_arrays(FRAMES, seed=6, global_z=0.0)['global_t']
    for i in range(FRAMES):
        jt = np.load(tmp_path / 'J' / 'models' / f'{i:06d}.npz')['trans']
        tt = np.load(tmp_path / 'T' / 'models' / f'{i:06d}.npz')['trans']
        np.testing.assert_allclose(jt, g[i] + (2 * i + 1) * delta, atol=1e-6)
        np.testing.assert_allclose(tt, g[i] + (i + 1) * delta, atol=1e-6)
        np.testing.assert_array_equal(seen[i].trans, tt)
    np.testing.assert_allclose(jser._acc_trans, 2 * FRAMES * delta,
                               atol=1e-6)
    np.testing.assert_allclose(tser._acc_trans, FRAMES * delta, atol=1e-6)
