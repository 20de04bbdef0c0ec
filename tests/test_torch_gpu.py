"""gsavatar_torch's CUDA kernels on the card, against their plain versions.

Marked `gpu`: each test skips without a CUDA GPU. The plain versions are
held against the JAX package on the CPU (tests/test_torch_raster.py,
tests/test_torch_render.py); here the kernels are held against the plain
versions on the same card. This file imports no JAX, so that it runs where
JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: K1 1e-5 absolute. The kernel rounds power, alpha and T exactly
as the plain version's tensor expression does, so the two include the same
pairs; the colour sums are taken in another order."""
import numpy as np
import pytest
import torch

from gsavatar_torch.camera.camera import make_camera
from gsavatar_torch.ops.rasterizer import composite
from gsavatar_torch.ops.rasterizer.pairs import build_pairs
from gsavatar_torch.ops.rasterizer.project import project
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
