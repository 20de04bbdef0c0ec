"""The port's tooling (gsavatar_torch/tooling, utils/draw.py, smpl/tools.py)
against the JAX package's (gsavatar/tooling, gsavatar/smpl/tools.py, which
call OpenCV, Pillow-free numpy and matplotlib) on the CPU, with the same
seeded inputs through both:

* CLIFF: the crop transform (with and without rotation), the bbox
  convention, the 6D rotation and the camera conversion bit-equal; `crop`
  and `process_image` bit-equal at up- and down-scaling crop sizes, with
  and without a bbox (the float resize is `cv2.resize`'s to the bit);
  `video_to_images` fails without ffmpeg as the JAX call fails;
  `images_to_video` writes the frames the JAX call writes;
* drawing: `draw.line` and `draw.circle` pixel-equal to `cv2.line` and
  `cv2.circle` (thickness 1-8, radius 0-30, ends off the image);
  `draw_skeleton` bit-equal (both bone tables, conf <= 0 joints, points
  off the image, line width 1-5, radius 1-8);
* the build steps: `downsample_video` and `extract_images_and_masks`
  (JPEG bytes equal, PNG pixels equal: the zlib streams may differ),
  `generate_camera_params` (the JSON's bytes), `extract_smpl_model_data`
  (the npz keys and dtypes equal, the values within 1e-5 as
  tests/test_torch_motion.py holds the LBS), `build_yolo_seg_dataset`,
  `mask_to_yolo_txt` (the text's bytes, the recovered mask's pixels), the
  YOLO steps' RuntimeError;
* the SMPL tools: `extract_smpl_parameters` on a pickle written here
  (scipy sparse J_regressor) key by key, `vitruvian_verts` within 1e-6,
  `plot_smpl`'s PNG decoded equal, its ImportError without matplotlib;
* chip_smoke.py phase 16's fixture (tests/fixtures/torch_tooling): the
  digests of both packages' build of the 12-frame 1920x1080 tree equal
  the committed ones."""
import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

import torch_dist_workers  # noqa: F401  (torch on one thread)

from gsavatar_torch.smpl import tools as ttools
from gsavatar_torch.smpl.body_model import synthetic_assets as t_assets
from gsavatar_torch.tooling import build_dataset as tbd
from gsavatar_torch.tooling import cliff as tcliff
from gsavatar_torch.tooling import skeleton as tskel
from gsavatar_torch.utils import draw, png

from gsavatar.smpl import tools as jtools
from gsavatar.smpl.body_model import synthetic_assets as j_assets
from gsavatar.tooling import build_dataset as jbd
from gsavatar.tooling import cliff as jcliff
from gsavatar.tooling import skeleton as jskel

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- CLIFF

@pytest.mark.parametrize('rot', [0.0, 17.5, -90.0])
def test_crop_transform_matches_jax(rot):
    rng = np.random.default_rng(1)
    for _ in range(20):
        center = rng.uniform(-50, 700, 2)
        scale = float(rng.uniform(0.2, 4.0))
        res = (int(rng.integers(64, 300)), int(rng.integers(48, 300)))
        _same(tcliff.get_transform(center, scale, res, rot),
              jcliff.get_transform(center, scale, res, rot))
        pt = rng.uniform(-20, 600, 2)
        for invert in (False, True):
            _same(tcliff.transform(pt, center, scale, res, invert, rot),
                  jcliff.transform(pt, center, scale, res, invert, rot))


def test_cliff_math_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(10):
        bbox = list(rng.uniform(0, 500, 2)) + list(rng.uniform(500, 900, 2))
        for rescale in (1.0, 1.1, 1.4):
            tc, ts = tcliff.bbox_from_detector(bbox, rescale)
            jc, js = jcliff.bbox_from_detector(bbox, rescale)
            _same(tc, jc)
            assert ts == js
    x = rng.normal(size=(7, 6))
    _same(tcliff.rot6d_to_rotmat(x), jcliff.rot6d_to_rotmat(x))
    cam = rng.normal(size=(5, 3)) + [1.0, 0.0, 0.0]
    center = rng.uniform(100, 800, (5, 2))
    scale = rng.uniform(0.5, 3.0, 5)
    shape = np.tile([1080.0, 1920.0], (5, 1))
    focal = np.full(5, 2202.9)
    _same(tcliff.cam_crop2full(cam, center, scale, shape, focal),
          jcliff.cam_crop2full(cam, center, scale, shape, focal))


# crop sizes from 0.1x to 6x the output's, tall and wide, in and off the
# image
@pytest.mark.parametrize('scale', [0.15, 0.6, 1.0, 1.28, 3.0, 7.5])
def test_crop_matches_jax(scale):
    rng = np.random.default_rng(int(scale * 100))
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    for center in ((320, 240), (20, 460), (700, -30)):
        for res in ((256, 192), (64, 48), (300, 301)):
            t, tul, tbr = tcliff.crop(img, center, scale, res)
            j, jul, jbr = jcliff.crop(img, center, scale, res)
            _same(t, j)
            _same(tul, jul)
            _same(tbr, jbr)


@pytest.mark.parametrize('with_bbox', [False, True])
def test_process_image_matches_jax(with_bbox):
    rng = np.random.default_rng(3 + with_bbox)
    for _ in range(6):
        h, w = int(rng.integers(80, 900)), int(rng.integers(80, 900))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        bbox = None
        if with_bbox:
            x0, y0 = rng.uniform(-40, w), rng.uniform(-40, h)
            bbox = [x0, y0, x0 + rng.uniform(4, w), y0 + rng.uniform(4, h)]
        for a, b in zip(tcliff.process_image(img, bbox),
                        jcliff.process_image(img, bbox)):
            _same(a, b)


def test_video_to_images_fails_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(FileNotFoundError):
        jcliff.video_to_images('in.mp4', str(tmp_path / 'j'))
    with pytest.raises(FileNotFoundError):
        tcliff.video_to_images('in.mp4', str(tmp_path / 't'))


def _read_video(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


def test_images_to_video_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    d = tmp_path / 'frames'
    d.mkdir()
    for i in range(4):
        img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        cv2.imwrite(str(d / f'{i:06d}.{"jpg" if i % 2 else "png"}'), img)
    jcliff.images_to_video(str(d), str(tmp_path / 'j.mp4'), 10.0)
    tcliff.images_to_video(str(d), str(tmp_path / 't.mp4'), 10.0)
    a, b = _read_video(tmp_path / 'j.mp4'), _read_video(tmp_path / 't.mp4')
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        _same(y, x)


# -------------------------------------------------------------- drawing

@pytest.mark.parametrize('thickness', [1, 2, 3, 5, 8])
def test_line_matches_opencv(thickness):
    rng = np.random.default_rng(thickness)
    for t in range(200):
        shape = (61, 83, 3) if t % 2 else (61, 83)
        lo, hi = (-60, 140) if t % 3 == 0 else (0, 61)
        p1 = tuple(int(v) for v in rng.integers(lo, hi, 2))
        p2 = tuple(int(v) for v in rng.integers(lo, hi, 2))
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        a = np.zeros(shape, np.uint8)
        b = np.zeros(shape, np.uint8)
        cv2.line(a, p1, p2, color, thickness)
        draw.line(b, p1, p2, color, thickness)
        _same(b, a)


def test_circle_matches_opencv():
    rng = np.random.default_rng(5)
    for t in range(300):
        c = tuple(int(v) for v in rng.integers(-30, 110, 2))
        r = int(rng.integers(0, 31))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        a = np.zeros((61, 83, 3), np.uint8)
        b = np.zeros((61, 83, 3), np.uint8)
        cv2.circle(a, c, r, color, -1)
        draw.circle(b, c, r, color)
        _same(b, a)


@pytest.mark.parametrize('topology', ['mpii', 'coco'])
@pytest.mark.parametrize('line_width', [1, 2, 3, 4, 5])
def test_draw_skeleton_matches_jax(topology, line_width):
    rng = np.random.default_rng(line_width + 10 * (topology == 'mpii'))
    for radius in range(1, 9):
        img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
        kp = np.concatenate([rng.uniform(-60, 220, (24, 2)),
                             rng.uniform(-0.5, 1.0, (24, 1))], 1)
        kp[13, 2] = 0.8 if topology == 'mpii' else 0.0
        _same(tskel.draw_skeleton(img.copy(), kp, line_width, radius),
              jskel.draw_skeleton(img.copy(), kp, line_width, radius))


def test_skeleton_tables_are_the_jax_ones():
    assert tskel.JOINT_NAMES == jskel.JOINT_NAMES
    assert tskel.SKELETON_COCO == jskel.SKELETON_COCO
    assert tskel.SKELETON_MPII == jskel.SKELETON_MPII
    assert tskel._JOINT_COLORS == jskel._JOINT_COLORS


# ---------------------------------------------------------- build steps

VIDEO_HW = (72, 96)
VIDEO_FRAMES = 7


def _masks(n, hw, seed):
    """Half-size mask stacks: a blob with a hole per frame, frame 2
    empty."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    out = np.zeros((n, h, w), bool)
    for i in range(n):
        if i == 2:
            continue
        cx, cy = rng.uniform(w / 3, 2 * w / 3), rng.uniform(h / 3, 2 * h / 3)
        r = ((xx - cx) / (w / 4)) ** 2 + ((yy - cy) / (h / 3)) ** 2
        out[i] = (r < 1) & ~(r < 0.15)
    return out


@pytest.fixture(scope='module')
def video(tmp_path_factory):
    """A short mp4v video written by OpenCV, and its mask stack."""
    d = tmp_path_factory.mktemp('video')
    rng = np.random.default_rng(6)
    path = str(d / 'in.mp4')
    h, w = VIDEO_HW
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), 25.0, (w, h))
    y, x = np.mgrid[:h, :w]
    for i in range(VIDEO_FRAMES):
        img = np.stack([100 + 80 * np.sin(x / 9 + i), 120 + 60 * np.cos(y / 7),
                        90 + 40 * np.sin((x + y) / 11)], -1)
        img += rng.normal(0, 3, img.shape)
        vw.write(np.clip(img, 0, 255).astype(np.uint8))
    vw.release()
    masks = str(d / 'masks.npy')
    np.save(masks, _masks(VIDEO_FRAMES, (h // 2, w // 2), 7))
    return path, masks


def test_downsample_video_matches_jax(video, tmp_path):
    jn = jbd.downsample_video(video[0], str(tmp_path / 'j.mp4'), every=3)
    tn = tbd.downsample_video(video[0], str(tmp_path / 't.mp4'), every=3)
    assert jn == tn == 3
    a, b = _read_video(tmp_path / 'j.mp4'), _read_video(tmp_path / 't.mp4')
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        _same(y, x)


@pytest.mark.parametrize('start', [0, 3])
def test_extract_images_and_masks_matches_jax(video, tmp_path, start):
    jn = jbd.extract_images_and_masks(*video, str(tmp_path / 'j'),
                                      start=start)
    tn = tbd.extract_images_and_masks(*video, str(tmp_path / 't'),
                                      start=start, device='cpu')
    assert jn == tn == VIDEO_FRAMES - start - (start <= 2)
    names = sorted(os.listdir(tmp_path / 'j' / '1'))
    assert sorted(os.listdir(tmp_path / 't' / '1')) == names
    for name in names:
        a, b = tmp_path / 'j' / '1' / name, tmp_path / 't' / '1' / name
        if name.endswith('.jpg'):
            assert b.read_bytes() == a.read_bytes(), name
        else:
            _same(png.read_png(str(b), 'gray'),
                  cv2.imread(str(a), cv2.IMREAD_GRAYSCALE))


def test_generate_camera_params_matches_jax(tmp_path):
    for w, h in ((1920, 1080), (1080, 1920), (641, 479)):
        jd = jbd.generate_camera_params(w, h, str(tmp_path / 'j.json'))
        td = tbd.generate_camera_params(w, h, str(tmp_path / 't.json'))
        assert td == jd
        assert (tmp_path / 't.json').read_bytes() == \
            (tmp_path / 'j.json').read_bytes()


@pytest.mark.parametrize('flip_root', [True, False])
def test_extract_smpl_model_data_matches_jax(tmp_path, flip_root):
    from torch_parity import motion_arrays
    npz = str(tmp_path / 'cliff.npz')
    np.savez(npz, **motion_arrays(3))
    ja, ta = j_assets(n_verts=6890, seed=0), t_assets(n_verts=6890, seed=0)
    jn = jbd.extract_smpl_model_data(npz, str(tmp_path / 'j'), ja, flip_root)
    tn = tbd.extract_smpl_model_data(npz, str(tmp_path / 't'), ta, flip_root,
                                     device='cpu')
    assert jn == tn == 3
    assert sorted(os.listdir(tmp_path / 't')) == \
        sorted(os.listdir(tmp_path / 'j'))
    for name in os.listdir(tmp_path / 'j'):
        a, b = np.load(tmp_path / 'j' / name), np.load(tmp_path / 't' / name)
        assert sorted(b.files) == sorted(a.files)
        for k in a.files:
            assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape, k
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5,
                                       err_msg=k)


def test_build_yolo_seg_dataset_matches_jax(tmp_path):
    src = tmp_path / 'src'
    src.mkdir()
    for i in range(3):
        (src / f'{i:06d}.jpg').write_bytes(bytes([i]) * 10)
        (src / f'{i:06d}.png').write_bytes(bytes([i + 7]) * 12)
    assert jbd.build_yolo_seg_dataset(str(src), str(tmp_path / 'j')) == \
        tbd.build_yolo_seg_dataset(str(src), str(tmp_path / 't')) == 3
    for sub in ('images', 'masks'):
        names = sorted(os.listdir(tmp_path / 'j' / sub))
        assert sorted(os.listdir(tmp_path / 't' / sub)) == names
        for n in names:
            assert (tmp_path / 't' / sub / n).read_bytes() == \
                (tmp_path / 'j' / sub / n).read_bytes()


def _mask_files(tmp_path):
    """PNG masks written by OpenCV: blobs with holes, several components,
    a component touching the border, specks under min_area, grey levels
    the threshold drops, and an empty mask."""
    rng = np.random.default_rng(8)
    out = []
    for i in range(8):
        h, w = int(rng.integers(60, 200)), int(rng.integers(60, 200))
        yy, xx = np.mgrid[:h, :w]
        m = np.zeros((h, w), np.uint8)
        for _ in range(int(rng.integers(0, 5)) if i else 0):
            cx, cy = rng.uniform(-10, w + 10), rng.uniform(-10, h + 10)
            a, b = rng.uniform(2, w / 2), rng.uniform(2, h / 2)
            r = ((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2
            m[r < 1] = 255
            m[r < 0.2] = 0
        m[rng.random((h, w)) < 0.001] = 255
        m[rng.random((h, w)) < 0.01] = 200
        path = str(tmp_path / f'm{i}.png')
        cv2.imwrite(path, m)
        out.append(path)
    return out


def test_mask_to_yolo_txt_matches_jax(tmp_path):
    for path in _mask_files(tmp_path):
        for eps in (0.0003, 0.01):
            jr = jbd.mask_to_yolo_txt(path, str(tmp_path / 'j.txt'),
                                      epsilon_frac=eps)
            tr = tbd.mask_to_yolo_txt(path, str(tmp_path / 't.txt'),
                                      epsilon_frac=eps)
            assert (tmp_path / 't.txt').read_bytes() == \
                (tmp_path / 'j.txt').read_bytes()
            _same(tr, jr)


def test_yolo_steps_raise_naming_ultralytics(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'ultralytics', None)
    for fn in (jbd.segment_video, tbd.segment_video):
        with pytest.raises(RuntimeError, match='ultralytics'):
            fn('in.mp4', str(tmp_path / 'm.npy'))
    for fn in (jbd.yolo_seg_inference, tbd.yolo_seg_inference):
        with pytest.raises(RuntimeError, match='ultralytics'):
            fn()


# ------------------------------------------------------------ SMPL tools

def _write_pickle(path, seed, n_verts=40):
    """A small SMPL-layout model pickle: scipy sparse J_regressor, dense
    (and list-valued) others, 12 shape directions."""
    import scipy.sparse
    rng = np.random.default_rng(seed)
    jr = rng.random((24, n_verts)) * (rng.random((24, n_verts)) < 0.2)
    data = {'J_regressor': scipy.sparse.csc_matrix(jr),
            'weights': rng.random((n_verts, 24)),
            'posedirs': rng.normal(size=(n_verts, 3, 207)),
            'shapedirs': rng.normal(size=(n_verts, 3, 12)),
            'v_template': rng.normal(size=(n_verts, 3)),
            'f': rng.integers(0, n_verts, (30, 3)).astype(np.uint32),
            'kintree_table': np.stack([np.arange(-1, 23), np.arange(24)])
            .tolist()}
    with open(path, 'wb') as f:
        pickle.dump(data, f, protocol=2)


def test_extract_smpl_parameters_matches_jax(tmp_path):
    paths = {}
    for i, g in enumerate(('female', 'male')):
        paths[g] = str(tmp_path / f'{g}.pkl')
        _write_pickle(paths[g], i)
    jtools.extract_smpl_parameters(paths, str(tmp_path / 'j'))
    ttools.extract_smpl_parameters(paths, str(tmp_path / 't'))
    names = sorted(os.listdir(tmp_path / 'j'))
    assert sorted(os.listdir(tmp_path / 't')) == names
    for name in names:
        a = np.load(tmp_path / 'j' / name)
        b = np.load(tmp_path / 't' / name)
        if name.endswith('.npy'):
            _same(b, a)
            continue
        assert sorted(b.files) == sorted(a.files)
        for k in a.files:
            _same(b[k], a[k])


@pytest.mark.parametrize('rest', ['template', 'minimal_shape'])
def test_vitruvian_verts_matches_jax(rest):
    ja, ta = j_assets(n_verts=2048, seed=1), t_assets(n_verts=2048, seed=1)
    shape = None
    if rest == 'minimal_shape':
        shape = ta.v_template + 0.01 * np.random.default_rng(9).normal(
            size=ta.v_template.shape).astype(np.float32)
    want = jtools.vitruvian_verts(ja, shape)
    got = ttools.vitruvian_verts(ta, shape, device='cpu')
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_plot_smpl_matches_jax(tmp_path):
    pytest.importorskip('matplotlib')
    rng = np.random.default_rng(10)
    verts = rng.normal(size=(300, 3)).astype(np.float32)
    joints = rng.normal(size=(24, 3)).astype(np.float32)
    a = jtools.plot_smpl(verts, joints=joints, out_path=str(tmp_path / 'j.png'))
    b = ttools.plot_smpl(torch.from_numpy(verts), joints=joints,
                         out_path=str(tmp_path / 't.png'))
    assert (a, b) == (str(tmp_path / 'j.png'), str(tmp_path / 't.png'))
    _same(png.read_png(b), png.read_png(a))


def test_plot_smpl_names_matplotlib_when_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='matplotlib'):
        ttools.plot_smpl(np.zeros((3, 3), np.float32))


# ----------------------------------------------- phase 16's fixture

def test_chip_smoke_tooling_fixture_digests(tmp_path):
    """Both packages' build of chip_smoke.py phase 16's tree (12 frames at
    1920x1080, the masks at 960x540) and its overlays give the committed
    digests (tests/fixtures/torch_tooling/digests.json), which phase 16
    holds the card's build to."""
    sys.path.insert(0, os.path.join(ROOT, 'tests', 'fixtures',
                                    'torch_tooling'))
    try:
        import make_fixtures
    finally:
        sys.path.pop(0)
    with open(os.path.join(ROOT, 'tests', 'fixtures', 'torch_tooling',
                           'digests.json')) as f:
        want = json.load(f)
    (tmp_path / 'j').mkdir()
    (tmp_path / 't').mkdir()
    assert make_fixtures.jax_digests(str(tmp_path / 'j')) == want
    assert make_fixtures.port_digests(str(tmp_path / 't')) == want
    shutil.rmtree(tmp_path)
