"""The port's real-data loaders against the JAX package's, on tiny on-disk
trees in each format (ZJU-MoCap: cam_params.json, per-view jpg/png frames,
models/*.npz; PeopleSnapshot: camera.pkl, image/, mask/, animnerf_models/),
written here with OpenCV as tests/test_real_loaders.py writes them.

Every split (train, val, test, predict, freeview) is built by both
packages and compared camera by camera. The JAX loaders run their Python
frame path (`zju_format.load_image_mask(use_native=False)`, OpenCV): the
native loader they take by default rounds the final /255 in float32 and
differs from it by one float32 ulp on some pixels (ROADMAP §3).
Tolerances:
* frames and masks exact: the port decodes, undistorts and resizes to
  OpenCV's integers (tests/test_torch_image_ops.py);
* matrices, fov, rotations, joints and bone transforms within 1e-6
  (absolute and relative): the same numpy recipe, then float32 tensors;
* indices, frame ids and image names equal;
* metadata and the pose ground truth within 1e-6, the frame dictionary
  equal; the point cloud within 1e-6.
One frame of a `Scene` built on the ZJU tree is rendered by both packages
(the same weights and arena) and held to the render gates of
tests/test_torch_render.py."""
import json
import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (ITERATION, assert_render_gates, close,
                          random_conv_params, to_np)

from gsavatar_torch.config import load_config as t_load_config
from gsavatar_torch.data import load_dataset as t_load_dataset
from gsavatar_torch.smpl import lbs as tlbs
from gsavatar_torch.smpl.body_model import synthetic_assets as t_assets

from gsavatar.config import load_config as j_load_config
from gsavatar.data import load_dataset as j_load_dataset

RAW = 1024          # ZJUMoCapDataset.RAW_HW
N_FRAMES = 3
TOL = 1e-6
SHAPE = ["dataset.img_hw=[64,64]", "dataset.n_points=768",
         "model.gaussian.capacity=1024", "rasterizer.max_pairs=65536",
         "opt.skinning_pool_size=2048", "opt.n_reg_pts=128"]


@pytest.fixture(autouse=True)
def jax_python_frame_path(monkeypatch):
    import gsavatar.native
    monkeypatch.setattr(gsavatar.native, 'available', lambda: False)


def _frame_smpl(assets, pose):
    """One posed frame's SMPL fit (the port's LBS on the synthetic body)."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    res = tlbs.lbs(torch.zeros((1, 10)), t(pose)[None],
                   t(assets.v_template)[None], t(assets.shapedirs),
                   t(assets.posedirs), t(assets.J_regressor), assets.parents,
                   t(assets.skinning_weights))
    return {'bone_transforms': res[3][0].numpy(),
            'trans': np.array([0.01, -0.02, 0.03], np.float32),
            'root_orient': pose[:3], 'pose_body': pose[3:66],
            'pose_hand': pose[66:72]}


def _poses(n):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        p = (0.1 * rng.standard_normal(72)).astype(np.float32)
        p[:3] = 0.0
        out.append(p)
    return out


def _write_frame(path_jpg, path_png, seed, raw):
    import cv2
    rng = np.random.default_rng(seed)
    img = (rng.random((raw, raw, 3)) * 255).astype(np.uint8)
    mask = np.zeros((raw, raw), np.uint8)
    cv2.circle(mask, (raw // 2, raw // 2), raw // 4, 255, -1)
    cv2.imwrite(str(path_jpg), img)
    cv2.imwrite(str(path_png), mask)


def _save_model(path, assets, pose):
    np.savez(path, minimal_shape=assets.v_template.astype(np.float16),
             betas=np.full(10, 0.1, np.float32), **_frame_smpl(assets, pose))


@pytest.fixture(scope='module')
def zju_root(tmp_path_factory):
    assets = t_assets(n_verts=6890, seed=0)
    root = tmp_path_factory.mktemp('zju')
    subj = root / 'S1'
    (subj / 'models').mkdir(parents=True)
    for f, pose in enumerate(_poses(N_FRAMES)):
        _save_model(subj / 'models' / f'{f:06d}.npz', assets, pose)
    seq = subj / 'canonical_pose_view1'
    seq.mkdir()
    for f in range(2):
        _save_model(seq / f'{f:06d}.npz', assets, np.zeros(72, np.float32))
    cam_params = {}
    for i, cam in enumerate(('1', '2', '5')):
        d = subj / cam
        d.mkdir()
        for f in range(N_FRAMES):
            _write_frame(d / f'{f:06d}.jpg', d / f'{f:06d}.png', i * 10 + f,
                         RAW)
        ang = 2 * np.pi * i / 8
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        cam_params[cam] = {
            'K': [[1100.0, 0.0, 500.0], [0.0, 1100.0, 520.0],
                  [0.0, 0.0, 1.0]],
            'D': [1e-3, 0.0, 0.0, 0.0, 0.0], 'R': R.tolist(),
            'T': [[0.0], [0.0], [2.5]]}
    with open(subj / 'cam_params.json', 'w') as fp:
        json.dump(cam_params, fp)
    return root


@pytest.fixture(scope='module')
def ps_root(tmp_path_factory):
    assets = t_assets(n_verts=6890, seed=0, gender='female')
    root = tmp_path_factory.mktemp('ps')
    subj = root / 'female-9-test'
    for d in ('animnerf_models', 'image', 'mask', 'rotating_models'):
        (subj / d).mkdir(parents=True)
    for f, pose in enumerate(_poses(N_FRAMES)):
        _save_model(subj / 'animnerf_models' / f'{f:06d}.npz', assets, pose)
        _write_frame(subj / 'image' / f'{f:06d}.jpg',
                     subj / 'mask' / f'{f:06d}.png', f, RAW)
    _save_model(subj / 'rotating_models' / '000000.npz', assets,
                np.zeros(72, np.float32))
    with open(subj / 'camera.pkl', 'wb') as fp:
        pickle.dump({'camera_f': [1100.0, 1090.0],
                     'camera_c': [505.0, 515.0],
                     'camera_k': np.array([-0.2, 0.05, 1e-3, -1e-3, 0.0],
                                          np.float32),
                     'height': RAW, 'width': RAW}, fp)
    return root


def _zju_overrides(root, group='zjumocap_377_mono'):
    return [
        f'dataset={group}', f'dataset.root_dir={root}',
        'dataset.subject=S1', "dataset.train_views=['1','2']",
        "dataset.val_views=['5']", "dataset.predict_views=['1']",
        f'dataset.train_frames=[0,{N_FRAMES},1]', 'dataset.val_frames=[0,1,1]',
        f'dataset.test_frames.view=[0,{N_FRAMES},2]',
        'dataset.predict_seq=3'] + SHAPE


def _ps_overrides(root, group='ps_female_3'):
    return [
        f'dataset={group}', f'dataset.root_dir={root}',
        'dataset.subject=female-9-test',
        f'dataset.train_frames=[0,{N_FRAMES},1]', 'dataset.val_frames=[0,1,1]',
        f'dataset.test_frames.pose=[0,{N_FRAMES},2]',
        'dataset.test_mode=pose', 'dataset.predict_frames=[0,0,1]'] + SHAPE


def _both(overrides, split):
    jcfg = j_load_config(overrides=overrides)
    tcfg = t_load_config(overrides)
    return (j_load_dataset(jcfg.dataset, split),
            t_load_dataset(tcfg['dataset'], split, device='cpu'))


def assert_same_cameras(jds, tds):
    assert len(tds) == len(jds) > 0
    for i in range(len(jds)):
        j, t = jds[i], tds[i]
        np.testing.assert_array_equal(to_np(t.image), np.asarray(j.image))
        np.testing.assert_array_equal(to_np(t.mask), np.asarray(j.mask))
        for f in ('world_view_transform', 'full_proj_transform',
                  'camera_center', 'rots', 'Jtrs', 'bone_transforms'):
            close(getattr(t, f), getattr(j, f), TOL, TOL, f)
        assert t.fovx == pytest.approx(j.fovx, rel=TOL)
        assert t.fovy == pytest.approx(j.fovy, rel=TOL)
        assert (t.width, t.height) == (j.width, j.height)
        assert t.latent_idx == int(j.latent_idx)
        assert t.pose_idx == int(j.pose_idx)
        assert t.in_frame_dict == float(j.in_frame_dict)
        assert (t.frame_id, t.cam_id, t.image_name) == \
            (j.frame_id, j.cam_id, j.image_name)


MD_ARRAYS = ('smpl_verts', 'minimal_shape', 'Jtr', 'skinning_weights',
             'bone_transforms_02v', 'faces', 'coord_min', 'coord_max',
             'posedirs', 'J_regressor', 'betas')
MD_LISTS = ('root_orient', 'pose_body', 'pose_hand', 'trans')


def assert_same_metadata(jmd, tmd):
    assert set(tmd) == set(jmd)
    for k in MD_ARRAYS:
        if k in jmd:
            close(tmd[k], jmd[k], TOL, TOL, k)
    for k in MD_LISTS:
        if k in jmd:
            close(np.stack(tmd[k]), np.stack(jmd[k]), TOL, TOL, k)
    close(tmd['aabb'].coord_min, jmd['aabb'].coord_min, TOL, TOL)
    close(tmd['aabb'].coord_max, jmd['aabb'].coord_max, TOL, TOL)
    for k in ('gender', 'frame_dict', 'frames', 'cameras_extent'):
        assert tmd.get(k) == jmd.get(k), k


ZJU_SPLITS = [('train', []), ('val', []), ('test', []), ('predict', []),
              ('test', ['dataset.freeview=true'])]


@pytest.mark.parametrize('split,extra', ZJU_SPLITS,
                         ids=['train', 'val', 'test', 'predict', 'freeview'])
def test_zju_split_matches_jax(zju_root, split, extra):
    jds, tds = _both(_zju_overrides(zju_root) + extra, split)
    if extra:
        # freeview: 101 orbit cameras x the test frames; compare the first
        # and one camera further round
        n = len(jds) // 101
        assert len(tds) == len(jds) == 101 * n
        sub = [0, 37 * n + 1]
        jds = [jds[i] for i in sub]
        tds = [tds[i] for i in sub]
        assert not np.allclose(to_np(tds[0].camera_center),
                               to_np(tds[1].camera_center))
    assert_same_cameras(jds, tds)
    if not extra:
        assert_same_metadata(jds.metadata, tds.metadata)
    if split == 'predict':
        assert tds[0].frame_id < 0 and tds[0].in_frame_dict == 0.0


PS_SPLITS = ['train', 'val', 'test', 'predict']


@pytest.mark.parametrize('split', PS_SPLITS)
def test_people_snapshot_split_matches_jax(ps_root, split):
    jds, tds = _both(_ps_overrides(ps_root), split)
    assert_same_cameras(jds, tds)
    assert_same_metadata(jds.metadata, tds.metadata)
    assert tds.metadata['gender'] == 'female'


@pytest.mark.parametrize('fmt', ['zju', 'ps'])
def test_cameras_without_ground_truth_read_no_frame(zju_root, ps_root, fmt,
                                                    monkeypatch):
    """`ground_truth=False` (the unscored predict split): the cameras carry
    no frame or mask and no image file is read; the rest is unchanged."""
    from gsavatar_torch.data import zju_format
    overrides = (_zju_overrides(zju_root) if fmt == 'zju'
                 else _ps_overrides(ps_root))
    cfg = t_load_config(overrides)['dataset']
    ds = t_load_dataset(cfg, 'predict')
    full = [ds[i] for i in range(len(ds))]

    def no_read(*args):
        raise AssertionError(f"read {args}")
    monkeypatch.setattr(zju_format, 'read_image', no_read)
    bare = t_load_dataset(cfg, 'predict', ground_truth=False)
    assert len(bare) == len(full) > 0
    for i in range(len(full)):
        assert bare[i].image is None and bare[i].mask is None
        for f in ('world_view_transform', 'full_proj_transform', 'rots',
                  'bone_transforms'):
            assert torch.equal(getattr(bare[i], f), getattr(full[i], f)), f
        assert bare[i].image_name == full[i].image_name


def test_preload_caches_each_camera(zju_root):
    cfg = t_load_config(_zju_overrides(zju_root))['dataset']
    ds = t_load_dataset(cfg, 'val')
    cam = ds[0]
    assert ds[0] is cam
    cfg['preload'] = False
    ds = t_load_dataset(cfg, 'val')
    again = ds[0]
    assert ds[0] is not again
    np.testing.assert_array_equal(again.image.numpy(), cam.image.numpy())
    with pytest.raises(IndexError):
        ds[len(ds)]


def test_white_background_and_lanczos_match_jax(zju_root):
    jds, tds = _both(_zju_overrides(zju_root)
                     + ['dataset.white_background=true',
                        'dataset.lanczos=true'], 'val')
    assert_same_cameras(jds, tds)
    img, msk = tds[0].image.numpy(), tds[0].mask.numpy() > 0
    assert img[~msk].min() == 1.0


def test_train_smpl_ground_truth_matches_jax(zju_root):
    """`train_smpl` is on in the default config (pose_correction=direct):
    the training metadata carries the selected frames' SMPL parameters."""
    jds, tds = _both(_zju_overrides(zju_root), 'train')
    assert tds.metadata['frames'] == [0, 1, 2]
    close(tds.metadata['betas'], jds.metadata['betas'], 0, 0)
    jcfg = j_load_config(overrides=_zju_overrides(zju_root)
                         + ['dataset.train_smpl=false'])
    tcfg = t_load_config(_zju_overrides(zju_root)
                         + ['dataset.train_smpl=false'])
    tmd = t_load_dataset(tcfg['dataset'], 'train').metadata
    assert 'root_orient' not in tmd
    assert set(tmd) == set(j_load_dataset(jcfg.dataset, 'train').metadata)


def test_point_cloud_matches_jax_and_is_cached(zju_root, tmp_path):
    """Each package samples into its own copy of the tree (the cache is a
    file in the subject directory), then reads the cache back."""
    out = {}
    for name, load_cfg, load_ds in (('jax', j_load_config, j_load_dataset),
                                    ('torch', t_load_config,
                                     t_load_dataset)):
        root = tmp_path / name
        shutil.copytree(zju_root, root)
        ply = root / 'S1' / 'cano_smpl.ply'
        if ply.exists():
            ply.unlink()
        cfg = load_cfg(overrides=_zju_overrides(root)) if name == 'jax' \
            else load_cfg(_zju_overrides(root))
        ds = load_ds(cfg.dataset if name == 'jax' else cfg['dataset'],
                     'train')
        first = ds.readPointCloud()
        assert ply.exists()
        out[name] = (first, ds.readPointCloud())
    (jp, jc), (jp2, jc2) = out['jax']
    (tp, tc), (tp2, tc2) = out['torch']
    assert tp.shape == (768, 3)
    close(tp, jp, TOL, TOL)
    close(tc, jc, 0, 0)
    close(tp2, jp2, TOL, TOL)
    close(tc2, jc2, 0, 0)
    close(tp2, tp, TOL, TOL)


def test_mydataset_reads_the_zju_layout(zju_root, monkeypatch):
    from gsavatar.data.mydataset import MyDataset as JMy
    from gsavatar_torch.data.mydataset import MyDataset as TMy
    assert TMy.RAW_HW == JMy.RAW_HW == (1080, 1920)
    monkeypatch.setattr(JMy, 'RAW_HW', (RAW, RAW))
    monkeypatch.setattr(TMy, 'RAW_HW', (RAW, RAW))
    jds, tds = _both(_zju_overrides(zju_root, 'zjumocap_001_mono')
                     + ["dataset.train_views=['1']"], 'train')
    assert type(tds).__name__ == 'MyDataset'
    assert_same_cameras(jds, tds)


ALL_GROUPS = ['zjumocap_001_mono', 'zjumocap_377_mono', 'zjumocap_386_mono',
              'zjumocap_387_mono', 'zjumocap_392_mono', 'zjumocap_393_mono',
              'zjumocap_394_mono', 'ps_female_3', 'ps_female_4', 'ps_male_3',
              'ps_male_4']


@pytest.mark.parametrize('group', ALL_GROUPS)
def test_every_dataset_group_loads_like_jax(group, zju_root, ps_root,
                                            monkeypatch):
    """Each subject's config composes in both packages and its loader
    builds the training split on the fixture (root, subject and frames
    clamped to it; the rest, zjumocap_387's per-axis padding included, from
    the group): the metadata and the first camera agree."""
    if group.startswith('ps_'):
        ov = [f'dataset={group}', f'dataset.root_dir={ps_root}',
              'dataset.subject=female-9-test',
              f'dataset.train_frames=[0,{N_FRAMES},1]'] + SHAPE
    else:
        ov = [f'dataset={group}', f'dataset.root_dir={zju_root}',
              'dataset.subject=S1', "dataset.train_views=['1']",
              f'dataset.train_frames=[0,{N_FRAMES},1]'] + SHAPE
    from gsavatar.data.mydataset import MyDataset as JMy
    from gsavatar_torch.data.mydataset import MyDataset as TMy
    monkeypatch.setattr(JMy, 'RAW_HW', (RAW, RAW))
    monkeypatch.setattr(TMy, 'RAW_HW', (RAW, RAW))
    jds, tds = _both(ov, 'train')
    assert type(tds).__name__ == type(jds).__name__
    assert_same_metadata(jds.metadata, tds.metadata)
    assert_same_cameras([jds[0]], [tds[0]])


DUMMY = ['dataset.name=dummy_dataset', 'dataset.n_verts=256',
         'dataset.img_hw=[32,32]']


def _dummy_pair(use_camera):
    """The JAX and the port's dummy dataset (the 570-frame track, no
    train_frames given), both with `use_camera`."""
    jcfg = j_load_config(overrides=['dataset=synthetic'] + DUMMY)
    tcfg = t_load_config(DUMMY)
    jd, td = jcfg.dataset.to_dict(), tcfg['dataset']
    del jd['train_frames'], td['train_frames']
    jd['use_camera'] = td['use_camera'] = use_camera
    from gsavatar.config.config import Config
    return (j_load_dataset(Config(jd), 'train'),
            t_load_dataset(td, 'train', device='cpu'))


def _same_fields(j, t):
    for f in ('world_view_transform', 'full_proj_transform',
              'camera_center', 'rots', 'Jtrs', 'bone_transforms'):
        close(getattr(t, f), getattr(j, f), TOL, TOL, f)
    assert (t.frame_id, t.cam_id, t.image_name, t.width, t.height) == \
        (j.frame_id, j.cam_id, j.image_name, j.width, j.height)


def test_dummy_dataset_is_the_synthetic_track(monkeypatch):
    """Without a camera (no OpenCV here: `CameraStream` cannot be made),
    `use_camera=True` serves the 570-frame pose track (seen by the two
    training views): the same cameras and ground truth as
    `use_camera=False`, and the JAX dataset's cameras. (The ground truth
    itself is the synthetic dataset's: the JAX package renders it with a
    per-tile pair cap the port does not have, so the pixels are not
    compared here.)"""
    monkeypatch.setitem(sys.modules, 'cv2', None)
    jds, tds = _dummy_pair(True)
    assert tds._stream is None and jds._stream is None
    plain = t_load_dataset(dict(tds.cfg, use_camera=False), 'train',
                           device='cpu')
    assert tds.frames == plain.frames == list(range(570))
    assert len(tds) == len(jds) == len(plain) == 570 * 2     # two views
    for i in (0, 301, 1139):
        t, p, j = tds[i], plain[i], jds[i]
        assert torch.equal(t.image, p.image) and torch.equal(t.mask, p.mask)
        _same_fields(j, t)


class SeededStream:
    """A webcam stand-in: seeded uint8 RGB frames, larger than the camera's
    size, a new one each time it is iterated."""

    def __init__(self):
        self.rng = np.random.default_rng(21)

    def __iter__(self):
        while True:
            yield self.rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)


def test_dummy_dataset_takes_webcam_frames_as_jax(monkeypatch):
    """A fake stream in both packages' `CameraStream`: each camera's image
    is the stream's frame / 255 cropped to the camera's size, equal to
    the JAX dataset's bit for bit, taken once per record (preload); the
    mask and the other fields stay the synthetic track's."""
    import gsavatar.motion.streams as jstreams
    import gsavatar_torch.motion.streams as tstreams
    monkeypatch.setattr(jstreams, 'CameraStream', SeededStream)
    monkeypatch.setattr(tstreams, 'CameraStream', SeededStream)
    jds, tds = _dummy_pair(True)
    assert isinstance(tds._stream, SeededStream)
    for i in (0, 7, 300):
        j, t = jds[i], tds[i]
        assert tuple(t.image.shape) == (32, 32, 3)
        np.testing.assert_array_equal(to_np(t.image), np.asarray(j.image))
        _same_fields(j, t)
        assert t.mask is not None and tuple(t.mask.shape) == (32, 32)
        assert tds[i] is t                      # kept, as JAX's preload


def test_scene_on_the_zju_tree_renders_like_jax(zju_root):
    """The port's `Scene` on the ZJU tree against the JAX package's loader,
    converter and arena on it: the same converter weights (numpy-seeded,
    carried through `convert`) and arena, one training camera rendered at
    eval."""
    from gsavatar.core import gaussians as JG
    from gsavatar.models.converter import build_converter as j_build
    from gsavatar.ops.rasterizer import RasterizeConfig
    from gsavatar.renderer import render as j_render
    from gsavatar_torch import convert
    from gsavatar_torch.inference import AvatarState, InferenceScene
    from gsavatar_torch.scene import Scene as TScene

    ov = _zju_overrides(zju_root)
    jcfg = j_load_config(overrides=ov)
    jtrain = j_load_dataset(jcfg.dataset, 'train')
    converter = j_build(jcfg, jtrain.metadata, assets=jtrain.assets)
    ts = TScene(t_load_config(ov), device='cpu')
    g = jcfg.model.gaussian
    pts, cols = jtrain.readPointCloud()
    jparams, jaux = jax.jit(lambda p, c: JG.create_from_pcd(
        p, c, int(g.capacity), False, 3, int(g.feature_dim)))(
            jnp.asarray(pts), jnp.asarray(cols))
    jcam = jtrain[0]
    gview = JG.make_view(jparams, jaux, use_sh=False)
    shapes = jax.eval_shape(lambda: converter.init(
        jax.random.PRNGKey(0), gview, jcam, 0))['params']
    params = random_conv_params(shapes, jtrain.metadata)
    h, w = jcfg.dataset.img_hw
    rc = RasterizeConfig(width=w, height=h, max_pairs=65536, chunk=32,
                         backend='pallas_interpret')
    pkg = j_render(converter, {'params': jax.tree.map(jnp.asarray, params)},
                   gview, jax.tree.map(jnp.asarray, jcam), ITERATION, rc,
                   jnp.zeros(3))
    want = np.asarray(jnp.clip(pkg.render, 0.0, 1.0))

    gp, ga = convert.arena(jax.tree.map(np.asarray, jparams),
                           jax.tree.map(np.asarray, jaux))
    scene = InferenceScene(ts.cfg, ts.metadata, ts.assets,
                           AvatarState(gp, ga,
                                       convert.converter_state(params)),
                           device='cpu')
    tcam = ts.train_dataset[0]
    assert tcam.image.shape == (h, w, 3)
    got = scene.render_frame(tcam, ITERATION)
    assert got.pair_overflow == 0 and got.n_pairs == int(pkg.n_pairs) > 0
    assert float(got.opacity_render.mean()) > 0.01
    assert_render_gates(got.render.clamp(0, 1).numpy(), want, 'image')
    # the scene's arena is seeded from the same point cloud
    tstate = ts.init_state()
    n = int(tstate.gauss_aux.alive.sum())
    close(tstate.gauss_params.xyz[:n], np.asarray(jparams.xyz)[:n], TOL, TOL)


def test_body_model_assets_load_like_jax(tmp_path):
    """`find_assets` reads a `body_models/misc` directory (the reference's
    npz layout: per-gender arrays, posedirs stored (V, 3, 207), faces,
    kintree_table.npy) when it exists and builds the synthetic body
    otherwise; both exactly as the JAX package does."""
    from gsavatar.smpl.body_model import find_assets as j_find
    from gsavatar_torch.smpl.body_model import find_assets as t_find
    a = t_assets(n_verts=300, seed=1)
    v = a.n_verts
    d = tmp_path / 'misc'
    d.mkdir()
    per_gender = {
        'v_templates.npz': a.v_template, 'shapedirs_all.npz': a.shapedirs,
        'posedirs_all.npz': a.posedirs.T.reshape(v, 3, -1),
        'J_regressors.npz': a.J_regressor,
        'skinning_weights_all.npz': a.skinning_weights}
    for name, arr in per_gender.items():
        np.savez(d / name, neutral=arr, female=arr * 0.5, male=arr * 2.0)
    np.savez(d / 'faces.npz', faces=a.faces)
    np.save(d / 'kintree_table.npy', np.stack([a.parents, np.arange(24)]))
    for where, gender in ((str(d), 'female'), (str(tmp_path / 'none'),
                                                'male')):
        j, t = j_find(where, gender), t_find(where, gender)
        assert t.gender == j.gender == gender
        for f in ('v_template', 'shapedirs', 'posedirs', 'J_regressor',
                  'skinning_weights', 'faces', 'parents'):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert t_find(str(d), 'female').posedirs.shape == (207, 3 * v)
