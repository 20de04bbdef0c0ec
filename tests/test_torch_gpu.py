"""gsavatar_torch's CUDA kernels on the card, against their plain versions.

Marked `gpu`: each test skips without a CUDA GPU. The plain versions are
held against the JAX package on the CPU (tests/test_torch_raster.py,
tests/test_torch_render.py); here the kernels are held against the plain
versions on the same card. This file imports no JAX, so that it runs where
JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: K1 1e-5 absolute. The kernel rounds power, alpha and T exactly
as the plain version's tensor expression does, so the two include the same
pairs; the colour sums are taken in another order. K2 1e-4 of each value's
own scale (`composite.composite_pairs_bwd_scale`: the sum over the tile's
pixels of its terms' magnitudes): the same pairs, but the 256-pixel sums,
the colour prefixes and T rounded in another order. K3 1e-5 of each segment's sum of |values| (f32 adds in
an order that changes from run to run) plus 4 float64 ulps of the plain
version's largest running sum. K4 1e-5 of each output's sum of |x| (the
block's 1024 rows added in another order). The small training step on the
card against the CPU: loss terms 1e-4 relative, each gradient leaf with a
cosine > 0.999 and a mean error < 1e-3 of its largest value (bench.py)."""
import numpy as np
import pytest
import torch

from gsavatar_torch.camera.camera import make_camera
from gsavatar_torch.ops import segsum_blocked
from gsavatar_torch.ops.rasterizer import composite
from gsavatar_torch.ops.rasterizer.pairs import build_pairs
from gsavatar_torch.ops.rasterizer.project import project
from gsavatar_torch.tools import profile_narrow_dma as K4
from gsavatar_torch.utils.transforms import covariance_from_scaling_rotation

pytestmark = pytest.mark.gpu

H = W = 128
GRID = 8
SMALL = ["dataset.img_hw=[64,64]", "dataset.n_verts=512",
         "dataset.n_points=768", "dataset.train_frames=[0,2,1]",
         "model.gaussian.capacity=1024", "rasterizer.max_pairs=65536"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device('cuda')


def _pairs(n, seed, scale, device):
    """A random scene 3 units in front of the camera, projected and paired
    on `device`."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    means = t(rng.uniform(-0.5, 0.5, (n, 3)))
    scales = t(scale * (0.5 + rng.random((n, 3))))
    cov = covariance_from_scaling_rotation(scales, 1.0,
                                           t(rng.normal(size=(n, 4))))
    cam = make_camera(R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), fovx=0.8,
                      fovy=0.8, width=W, height=H, rots=np.zeros((1, 24, 9)),
                      Jtrs=np.zeros((1, 24, 3)),
                      bone_transforms=np.tile(np.eye(4), (24, 1, 1)),
                      device=device)
    p = project(means, cov, cam.world_view_transform, cam.full_proj_transform,
                cam.tanfovx, cam.tanfovy, W, H)
    return build_pairs(p, t(rng.random((n, 3))),
                       t(rng.uniform(0.3, 0.99, (n, 1))), GRID, GRID, 2 ** 18)


@pytest.mark.parametrize('n,seed,scale', [(200, 0, 0.05), (3000, 1, 0.08)],
                         ids=['sparse', 'saturating'])
def test_k1_kernel_matches_plain(cuda, n, seed, scale):
    pa = _pairs(n, seed, scale, cuda)
    assert pa.n_pairs > 0 and pa.pair_overflow == 0
    before = composite.composite_pairs_fwd.launches
    got = composite.composite_pairs_fwd(pa.pair_data, pa.tile_start, GRID)
    torch.cuda.synchronize()
    assert composite.composite_pairs_fwd.launches == before + 1
    want = composite.composite_pairs_fwd_plain(pa.pair_data, pa.tile_start,
                                               GRID)
    assert got.shape == (GRID * GRID, 8, 256)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-5)
    if seed == 1:     # dense enough that some pixels hit the T floor
        assert float(got[:, 4].min()) < 1e-3


def test_k1_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    pd = torch.zeros((4, 12), device=cuda)
    ts = torch.tensor([0, 4], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        composite.composite_pairs_fwd(pd.double(), ts, 1)
    with pytest.raises(ValueError):
        composite.composite_pairs_fwd(pd[:, :9], ts, 1)
    with pytest.raises(ValueError):
        composite.composite_pairs_fwd(torch.zeros((12, 4), device=cuda).T,
                                      ts, 1)
    with pytest.raises(ValueError):
        composite.composite_pairs_fwd(pd, ts.long(), 1)


def test_render_on_the_card_matches_the_cpu(cuda):
    """A small avatar through InferenceScene on the card and on the CPU:
    bench.py's render gates (mean error < 1e-4, a fraction < 1e-3 of pixels
    off by more than 1e-2)."""
    from gsavatar_torch.inference import synthetic_scene
    gpu, cams = synthetic_scene(SMALL, 0, cuda)
    cpu, _ = synthetic_scene(SMALL, 0, 'cpu')
    before = composite.composite_pairs_fwd.launches
    a = gpu.render_frame(cams[1].to(cuda))
    b = cpu.render_frame(cams[1])
    assert composite.composite_pairs_fwd.launches == before + 1
    assert a.pair_overflow == 0 and b.pair_overflow == 0 and b.n_pairs > 0
    for x, y in ((a.render.clamp(0, 1), b.render.clamp(0, 1)),
                 (a.opacity_render, b.opacity_render)):
        d = (x.double().cpu() - y.double()).abs()
        assert float(d.mean()) < 1e-4
        assert float((d > 1e-2).double().mean()) < 1e-3


@pytest.mark.parametrize('n,seed,scale', [(200, 0, 0.05), (3000, 1, 0.08)],
                         ids=['sparse', 'saturating'])
def test_k2_kernel_matches_plain(cuda, n, seed, scale):
    pa = _pairs(n, seed, scale, cuda)
    fwd = composite.composite_pairs_fwd(pa.pair_data, pa.tile_start, GRID)
    ct = torch.rand(fwd.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(seed)) - 0.5
    before = composite.composite_pairs_bwd.launches
    got = composite.composite_pairs_bwd(pa.pair_data, pa.tile_start, ct, fwd,
                                        GRID)
    torch.cuda.synchronize()
    assert composite.composite_pairs_bwd.launches == before + 1
    want = composite.composite_pairs_bwd_plain(pa.pair_data, pa.tile_start,
                                               ct, fwd, GRID)
    assert got.shape == pa.pair_data.shape
    assert not got[:, 9:].any()
    scale = composite.composite_pairs_bwd_scale(pa.pair_data, pa.tile_start,
                                                ct, fwd, GRID)
    assert bool(((got - want).abs() <= 1e-4 * scale).all())
    assert float(want[:, :9].abs().amax(0).min()) > 0.0


@pytest.mark.parametrize('M,C,S', [(5000, 2, 1200), (200000, 9, 50000),
                                   (3000000, 2, 1 << 20), (4000, 3, 700),
                                   (40000, 6, 9000)])
def test_k3_kernel_matches_plain(cuda, M, C, S):
    """Sorted ids with empty segments and dropped ids (>= S) whose rows
    hold NaN."""
    g = torch.Generator(cuda).manual_seed(M)
    ids = torch.sort(torch.randint(0, S + S // 20, (M,), device=cuda,
                                   dtype=torch.int32, generator=g)).values
    values = torch.randn((M, C), device=cuda, generator=g)
    values[ids >= S] = float('nan')
    before = segsum_blocked.segment_sum_sorted_blocked.launches
    got = segsum_blocked.segment_sum_sorted_blocked(values, ids, S)
    torch.cuda.synchronize()
    assert segsum_blocked.segment_sum_sorted_blocked.launches == before + 1
    plain = segsum_blocked.segment_sum_sorted_blocked_plain
    want = plain(values, ids, S)
    mag = plain(values.abs(), ids, S)
    floor = 4 * torch.finfo(torch.float64).eps * float(
        values.nan_to_num(0.0).double().abs().sum(0).max())
    assert got.shape == (S, C) and bool(got.isfinite().all())
    assert bool(((got - want).abs() <= 1e-5 * mag + floor).all())


def test_k2_k3_wrappers_reject_what_the_kernels_do_not_take(cuda):
    pd = torch.zeros((4, 12), device=cuda)
    ts = torch.tensor([0, 4], dtype=torch.int32, device=cuda)
    ct = torch.zeros((1, 8, 256), device=cuda)
    bwd = composite.composite_pairs_bwd
    with pytest.raises(ValueError):
        bwd(pd.double(), ts, ct, ct, 1)
    with pytest.raises(ValueError):
        bwd(pd, ts, ct[:, :5], ct, 1)
    with pytest.raises(ValueError):
        bwd(pd, ts, ct, ct.transpose(1, 2).contiguous().transpose(1, 2), 1)
    with pytest.raises(ValueError):
        bwd(pd, ts, ct.cpu(), ct, 1)
    k3 = segsum_blocked.segment_sum_sorted_blocked
    v = torch.zeros((10, 2), device=cuda)
    ids = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        k3(v, ids.long(), 4)
    for c in (1, 4, 17):     # built for the training step's 2, 3, 6, 9
        with pytest.raises(ValueError):
            k3(torch.zeros((10, c), device=cuda), ids, 4)
    with pytest.raises(ValueError):
        k3(torch.zeros((2, 10), device=cuda).T, ids, 4)
    with pytest.raises(ValueError):
        k3(v, ids[:5], 4)


@pytest.mark.parametrize('n_blocks', [1, 2048], ids=['one', 'probe'])
def test_k4_kernel_matches_plain(cuda, n_blocks):
    x = torch.randn((n_blocks * 1024, 12), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(n_blocks))
    before = K4.run.launches
    got = K4.run(x)
    torch.cuda.synchronize()
    assert K4.run.launches == before + 1
    want = K4.run_plain(x)
    mag = x.abs().view(-1, 1024, 12).sum(1)
    assert got.shape == (n_blocks, 12)
    assert bool(((got - want).abs() <= 1e-5 * mag).all())


def test_k4_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    for bad in (torch.zeros((1000, 12), device=cuda),
                torch.zeros((1024, 12), device=cuda, dtype=torch.float64),
                torch.zeros((1024, 16), device=cuda),
                torch.zeros((12, 1024), device=cuda).T,
                torch.zeros((1024 * 12 + 1,), device=cuda)[1:].view(1024,
                                                                     12)):
        with pytest.raises(ValueError):
            K4.run(bad)


def _small_train_scene(device):
    from gsavatar_torch.config import load_config
    from gsavatar_torch.scene import Scene
    cfg = load_config(SMALL + ["dataset.n_target_gaussians=512",
                               "opt.skinning_pool_size=2048",
                               "opt.n_reg_pts=128"])
    scene = Scene(cfg, seed=0, device=device)
    return cfg, scene, scene.init_state()


def test_small_train_step_on_the_card_matches_the_cpu(cuda):
    """One forward and backward of the training step from the same state,
    camera and draws, past every delay gate: the loss terms and every
    gradient leaf (K1, K2 and K3 on the card; their plain versions on the
    CPU)."""
    from gsavatar_torch.train import draw, loss_weights, make_grad_fn
    cfg, cpu, cpu_state = _small_train_scene('cpu')
    _, gpu, gpu_state = _small_train_scene(cuda)
    gpu.converter.load_state_dict(cpu.converter.state_dict())
    gpu_state.gauss_params = cpu_state.gauss_params.map(lambda x: x.to(cuda))
    gpu_state.gauss_aux = cpu_state.gauss_aux.map(lambda x: x.to(cuda))
    cam = cpu.train_dataset[0]
    draws = draw(cpu, cpu_state.generator)
    it = 6000
    w = loss_weights(cfg, it)
    bucket = cpu.bucket_for(int(cpu_state.gauss_aux.alive.sum()))
    counts = (composite.composite_pairs_bwd.launches,
              segsum_blocked.segment_sum_sorted_blocked.launches)
    m_g, _, g_g = make_grad_fn(gpu)(
        gpu_state, cam.to(cuda).replace(image=cam.image.to(cuda),
                                        mask=cam.mask.to(cuda)),
        it, w, draws.to(cuda), 0, bucket, gpu.raster_config)
    torch.cuda.synchronize()
    assert composite.composite_pairs_bwd.launches == counts[0] + 1
    assert segsum_blocked.segment_sum_sorted_blocked.launches == counts[1] + 6
    m_c, _, g_c = make_grad_fn(cpu)(cpu_state, cam, it, w, draws, 0, bucket,
                                    cpu.raster_config)
    for k, v in m_c.items():
        if k.startswith('loss/') and abs(float(v)) > 1e-9:
            assert abs(float(m_g[k]) - float(v)) <= 1e-4 * abs(float(v)), k
    leaves = [(k, g_g['conv'][k], v) for k, v in g_c['conv'].items()]
    leaves += [(f, getattr(g_g['gauss'], f), getattr(g_c['gauss'], f))
               for f in ('xyz', 'features_dc', 'features_rest', 'scaling',
                         'rotation', 'opacity')]
    leaves.append(('means2d', g_g['means2d'], g_c['means2d']))
    for name, a, b in leaves:
        a, b = a.double().cpu().reshape(-1), b.double().reshape(-1)
        if not float(b.abs().max()) > 0.0:
            continue
        rel = float((a - b).abs().mean()) / max(float(b.abs().max()), 1e-3)
        cos = float(a @ b) / (float(a.norm()) * float(b.norm()))
        assert cos > 0.999 and rel < 1e-3, (name, cos, rel)
