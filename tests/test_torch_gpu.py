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
the colour prefixes and T rounded in another order. K1's alpha and
final_T rows equal the plain version's exactly. K3 1e-5 of each segment's
sum of |values| (f32 adds in a fixed order other than the plain version's)
plus 4 float64 ulps of the plain version's largest running sum, and the
same bits on a second launch. K4 1e-5 of each output's sum of |x| (the
block's 1024 rows added in another order). The small training step on the
card against the CPU: loss terms 1e-4 relative, each gradient leaf with a
cosine > 0.999 and a mean error < 1e-3 of its largest value (bench.py).
The serving path: the render of `InferenceScene.from_smpl_npz` on the card
against the CPU's to the render gates; the float32 resize and the
composite of the apps (`body_replace.composite_frame`) equal bit for
bit. A B = 2 step (`parallel.frames_per_step`): the small step's gates on
each frame and on the mean loss. A 2-subject run on the card equals its
two single runs on the card bit for bit, since every operation of the
step is deterministic there (cuDNN held to deterministic algorithms; K2
and K3 give the same bits on every launch). K1 and K2 over one model
rank's tile range (`tile_base`): the same tolerances on the range, and
the ranges put together equal to the whole launch bit for bit. The
tooling: chip_smoke.py phase 16's tree built on the card gives the
committed digests; the threaded preload (`native.decode_batch`,
`Prefetcher`) equals the one-frame path on the card bit for bit. K5, the
converter's optimizer step, at the zju377_full recipe's leaves: bit for
bit where the clip scales nothing (it rounds every operation as the plain
version's expressions do); with the clip engaged the norm within 1e-6
relative (f32 sums in another order) and the parameters and moments within
what that gap and their roundings let through (`chip_smoke.k5_gaps`). The
converter at playback as a CUDA graph (`converter_graphs.py`), in each of
the benchmark's three playback recipes: a replayed frame's positions,
colours and image equal the eager frame's bit for bit (the same kernels on
the same inputs), also in a package kept while two later frames replayed;
a capture that reads the device leaves its key eager."""
import numpy as np
import pytest
import torch

import torch_dist_workers  # noqa: F401  (torch on one thread)

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
    assert torch.equal(got[:, 3:5], want[:, 3:5])
    if seed == 1:     # dense enough that some pixels hit the T floor
        assert float(got[:, 4].min()) < 1e-3


def _heavy_frame(device, seed=7, grid=4, heavy=5, n_heavy=12000):
    """A grid x grid tile frame whose tile `heavy` holds n_heavy pairs, the
    others up to 40. Faint splats (opacity under 0.012) cover the heavy
    tile, and every 40th is an opaque one on its lowest four pixel rows, so
    pixels there stop while the others walk every pair."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 41, size=grid * grid)
    counts[heavy] = n_heavy
    rows = []
    for t, n in enumerate(counts):
        x0, y0 = (t % grid) * 16, (t // grid) * 16
        m2d = np.array([x0 + 8, y0 + 8]) + rng.uniform(-10, 10, (n, 2))
        sx, sy = rng.uniform(0.7, 4.0, (2, n))
        opac = rng.uniform(0.004, 0.012, n)
        if t == heavy:
            m2d[::40, 1] = rng.uniform(y0 + 12, y0 + 16, len(m2d[::40]))
            opac[::40] = 0.99
        rho = rng.uniform(-0.6, 0.6, n)
        det = (sx * sy) ** 2 * (1 - rho ** 2)
        conic = np.stack([sy ** 2 / det, -rho * sx * sy / det,
                          sx ** 2 / det], 1)
        rows.append(np.concatenate([m2d, conic, rng.random((n, 3)),
                                    opac[:, None], np.zeros((n, 3))], 1))
    pd = torch.as_tensor(np.concatenate(rows).astype(np.float32),
                         device=device)
    ts = torch.as_tensor(np.r_[0, np.cumsum(counts)].astype(np.int32),
                         device=device)
    return pd, ts


def test_k1_heavy_tile_among_light_tiles(cuda):
    """`_heavy_frame`: the heavy tile is walked by eight (tile, 32-pixel
    group) units in batches, some of whose pixels stop. Alpha and final_T
    equal the plain version's exactly, colour within 1e-5."""
    grid, heavy = 4, 5
    pd, ts = _heavy_frame(cuda, grid=grid, heavy=heavy)
    before = composite.composite_pairs_fwd.launches
    got = composite.composite_pairs_fwd(pd, ts, grid)
    torch.cuda.synchronize()
    assert composite.composite_pairs_fwd.launches == before + 1
    want = composite.composite_pairs_fwd_plain(pd, ts, grid)
    assert torch.equal(got[:, 3:5], want[:, 3:5])
    assert float((got[:, 0:3] - want[:, 0:3]).abs().max()) <= 1e-5
    assert not got[:, 5:].any()
    # which pixels of the heavy tile stop: the plain version's running
    # product falls below 1e-4 at a pair it does not skip
    d = pd[int(ts[heavy]):int(ts[heavy + 1])]
    px, py = composite.pixel_coords(grid * grid, grid, cuda)
    dx, dy = d[:, 0:1] - px[heavy], d[:, 1:2] - py[heavy]
    power = -0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) \
        - d[:, 3:4] * dx * dy
    alpha = torch.clamp_max(d[:, 8:9] * torch.exp(power), 0.99)
    skip = (power > 0.0) | (alpha < 1.0 / 255.0)
    T_after = torch.cumprod(1.0 - torch.where(skip, 0.0, alpha), dim=0)
    stopped = (~skip & (T_after < 1e-4)).any(0)
    assert bool(stopped.any()) and not bool(stopped.all())


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


def _k2_holds(pd, ts, ct, fwd, grid):
    """K2 launched twice on one input: one count per launch, every value
    within 1e-4 of its own scale of the plain version, columns 9-11 zero,
    the same bits both times."""
    bwd = composite.composite_pairs_bwd
    before = bwd.launches
    got = bwd(pd, ts, ct, fwd, grid)
    again = bwd(pd, ts, ct, fwd, grid)
    torch.cuda.synchronize()
    assert bwd.launches == before + 2
    want = composite.composite_pairs_bwd_plain(pd, ts, ct, fwd, grid)
    scale = composite.composite_pairs_bwd_scale(pd, ts, ct, fwd, grid)
    assert got.shape == pd.shape and bool(got.isfinite().all())
    assert not got[:, 9:].any()
    assert bool(((got - want).abs() <= 1e-4 * scale).all())
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    return got, want


def _cotangent(fwd, seed):
    return torch.rand(fwd.shape, device=fwd.device,
                      generator=torch.Generator(fwd.device).manual_seed(
                          seed)) - 0.5


@pytest.mark.parametrize('n,seed,scale', [(200, 0, 0.05), (3000, 1, 0.08)],
                         ids=['sparse', 'saturating'])
def test_k2_kernel_matches_plain(cuda, n, seed, scale):
    pa = _pairs(n, seed, scale, cuda)
    fwd = composite.composite_pairs_fwd(pa.pair_data, pa.tile_start, GRID)
    _, want = _k2_holds(pa.pair_data, pa.tile_start, _cotangent(fwd, seed),
                        fwd, GRID)
    assert float(want[:, :9].abs().amax(0).min()) > 0.0


@pytest.mark.parametrize('M', [2, 4])
def test_k1_k2_tile_ranges(cuda, M):
    """K1 and K2 over each of the M tile ranges of the model ranks
    (`tile_base`) against their plain versions on that range, K2's rows
    outside the range's pairs zero, and the ranges put together (K1's
    stacked, K2's added) equal to the whole launch bit for bit."""
    pa = _pairs(3000, 1, 0.08, cuda)
    pd, ts = pa.pair_data, pa.tile_start
    whole = composite.composite_pairs_fwd(pd, ts, GRID)
    ct = _cotangent(whole, 3)
    whole_g = composite.composite_pairs_bwd(pd, ts, ct, whole, GRID)
    per = GRID * GRID // M
    outs, total = [], torch.zeros_like(whole_g)
    for base in range(0, GRID * GRID, per):
        r = ts[base:base + per + 1]
        ct_r, fwd_r = ct[base:base + per].contiguous(), whole[base:base + per]
        out = composite.composite_pairs_fwd(pd, r, GRID, base)
        g = composite.composite_pairs_bwd(pd, r, ct_r, fwd_r, GRID, base)
        torch.cuda.synchronize()
        want = composite.composite_pairs_fwd_plain(pd, r, GRID, base)
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=1e-5)
        assert torch.equal(out[:, 3:5], want[:, 3:5])
        g_want = composite.composite_pairs_bwd_plain(pd, r, ct_r, fwd_r, GRID,
                                                     base)
        scale = composite.composite_pairs_bwd_scale(pd, r, ct_r, fwd_r, GRID,
                                                    base)
        assert bool(((g - g_want).abs() <= 1e-4 * scale).all())
        assert not g[:int(r[0])].any() and not g[int(r[-1]):].any()
        outs.append(out)
        total += g
    assert torch.equal(torch.cat(outs), whole)
    assert torch.equal(total, whole_g)


def test_k2_heavy_tile_among_light_tiles(cuda):
    """`_heavy_frame`'s 12,000-pair tile: the units of its lowest pixel
    rows stop while the others walk every pair, so the eight partial rows
    of a pair row end at different rows."""
    grid, heavy = 4, 5
    pd, ts = _heavy_frame(cuda, grid=grid, heavy=heavy)
    fwd = composite.composite_pairs_fwd(pd, ts, grid)
    got, _ = _k2_holds(pd, ts, _cotangent(fwd, 5), fwd, grid)
    # the (tile, 32-pixel group) units all of whose pixels stop
    d = pd[int(ts[heavy]):int(ts[heavy + 1])]
    px, py = composite.pixel_coords(grid * grid, grid, cuda)
    dx, dy = d[:, 0:1] - px[heavy], d[:, 1:2] - py[heavy]
    power = -0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) \
        - d[:, 3:4] * dx * dy
    alpha = torch.clamp_max(d[:, 8:9] * torch.exp(power), 0.99)
    skip = (power > 0.0) | (alpha < 1.0 / 255.0)
    T_after = torch.cumprod(1.0 - torch.where(skip, 0.0, alpha), dim=0)
    stopped = (~skip & (T_after < 1e-4)).any(0).view(8, 32).all(1)
    assert bool(stopped.any()) and not bool(stopped.all())
    assert bool(got[int(ts[heavy]):int(ts[heavy + 1]), :9].any())


def _opaque_cover(device, n=3000):
    """One tile of n pairs led by two opaque splats that cover it (alpha
    clamped to 0.99 at every pixel: T = 0.01, then under 1e-4), so every
    pixel includes the first and stops at the second, the earliest a pixel
    can stop; faint splats follow."""
    rng = np.random.default_rng(3)
    rows = np.zeros((n, 12), np.float32)
    rows[:, 0:2] = 8.0 + rng.uniform(-6, 6, (n, 2))
    rows[:, 2] = rows[:, 4] = 0.3
    rows[:, 5:8] = rng.random((n, 3))
    rows[:, 8] = 0.05
    rows[:2, 2] = rows[:2, 4] = 1e-6
    rows[:2, 8] = 1.0
    return (torch.as_tensor(rows, device=device),
            torch.tensor([0, n], dtype=torch.int32, device=device))


@pytest.mark.parametrize('case', ['no_pairs', 'empty_tiles', 'opaque_cover'])
def test_k2_edge_cases(cuda, case):
    """P = 0 (every tile empty); a frame with empty tiles between full
    ones; a tile whose every pixel stops at its second pair, so the kernel
    leaves all later rows to the zeros past each unit's stop."""
    grid = 4
    if case == 'no_pairs':
        pd = torch.zeros((0, 12), device=cuda)
        ts = torch.zeros(grid * grid + 1, dtype=torch.int32, device=cuda)
    elif case == 'empty_tiles':
        pd, ts = _heavy_frame(cuda, seed=11, grid=grid, heavy=9,
                              n_heavy=500)
        counts = torch.diff(ts)
        tile = torch.repeat_interleave(
            torch.arange(grid * grid, device=cuda), counts)
        pd = pd[tile % 3 != 0].contiguous()
        counts[::3] = 0
        ts = torch.cat([ts[:1], torch.cumsum(counts, 0)]).to(torch.int32)
    else:
        grid = 1
        pd, ts = _opaque_cover(cuda)
    fwd = composite.composite_pairs_fwd(pd, ts, grid)
    got, want = _k2_holds(pd, ts, _cotangent(fwd, 1), fwd, grid)
    if case == 'no_pairs':
        assert got.shape == (0, 12)
    elif case == 'empty_tiles':
        assert int((torch.diff(ts) == 0).sum()) >= grid * grid // 3
    else:
        assert bool(want[0, 5:8].all()) and not want[1:].any()
        assert not got[1:].any()


def _k3_holds(values, ids, S):
    """K3 launched twice on (values, ids): within tolerance of the plain
    version, every output row written, the same bits both times."""
    k3 = segsum_blocked.segment_sum_sorted_blocked
    before = k3.launches
    got = k3(values, ids, S)
    again = k3(values, ids, S)
    torch.cuda.synchronize()
    assert k3.launches == before + 2
    plain = segsum_blocked.segment_sum_sorted_blocked_plain
    want = plain(values, ids, S)
    mag = plain(values.abs(), ids, S)
    floor = 4 * torch.finfo(torch.float64).eps * float(
        values.nan_to_num(0.0).double().abs().sum(0).max())
    assert got.shape == (S, values.shape[1]) and bool(got.isfinite().all())
    assert bool(((got - want).abs() <= 1e-5 * mag + floor).all())
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    return got


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
    _k3_holds(values, ids, S)


def _runs(lengths, S, seed):
    """Sorted int32 ids: runs of the given lengths on distinct segments."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.choice(S, size=len(lengths), replace=False))
    return np.repeat(seg, lengths).astype(np.int32)


@pytest.mark.parametrize('C', [2, 3, 6, 9])
@pytest.mark.parametrize('case', ['one_segment', 'long_segments', 'ragged',
                                  'no_rows', 'no_segments', 'empty',
                                  'only_dropped'])
def test_k3_edge_cases(cuda, case, C):
    """One segment holding every row; segments of hundreds to thousands of
    rows, longer than the kernel's chunk (64 rows at these sizes); a row
    count that is no multiple of the chunk; M = 0; S = 0; both; only
    dropped ids, with NaN rows."""
    rng = np.random.default_rng(C)
    S = 700
    if case == 'one_segment':
        ids = np.full(300_001, 5, np.int32)
    elif case == 'long_segments':
        ids = _runs(rng.integers(200, 6000, size=40), S, C)
    elif case == 'ragged':
        ids = np.sort(rng.integers(0, S, size=256 * 41 + 77)).astype(np.int32)
    elif case in ('no_rows', 'empty'):
        ids = np.zeros(0, np.int32)
    elif case == 'no_segments':
        ids = np.sort(rng.integers(0, 50, size=1000)).astype(np.int32)
    else:
        ids = np.sort(rng.integers(S, S + 30, size=3000)).astype(np.int32)
    if case in ('no_segments', 'empty'):
        S = 0
    M = ids.shape[0]
    values = torch.as_tensor(
        rng.standard_normal((M, C)).astype(np.float32), device=cuda)
    t_ids = torch.as_tensor(ids, device=cuda)
    values[t_ids >= S] = float('nan')
    got = _k3_holds(values, t_ids, S)
    if case in ('only_dropped', 'no_rows'):
        assert not got.any()


def test_k3_same_bits_on_every_launch(cuda):
    """The hash-table backward's shape (16 levels x 8 corners x 53,248
    rows into 16 x 2^16 segments), the coarse levels crowded into few
    segments: five launches, one set of bits."""
    g = torch.Generator(cuda).manual_seed(4)
    levels, rows, size = 16, 8 * 53248, 1 << 16
    cells = torch.tensor([300 if lvl < 3 else size for lvl in range(levels)],
                         device=cuda)[:, None]
    local = (torch.rand((levels, rows), device=cuda, generator=g)
             ** 2 * cells).int()
    ids = (torch.sort(local, dim=1).values
           + torch.arange(levels, device=cuda, dtype=torch.int32)[:, None]
           * size).reshape(-1)
    values = torch.randn((ids.shape[0], 2), device=cuda, generator=g)
    k3 = segsum_blocked.segment_sum_sorted_blocked
    first = _k3_holds(values, ids, levels * size).view(torch.int32)
    for _ in range(3):
        assert torch.equal(k3(values, ids, levels * size).view(torch.int32),
                           first)


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
    for cycles in (torch.zeros((8, 7, 2), dtype=torch.int32, device=cuda),
                   torch.zeros((1, 7, 2), dtype=torch.int64, device=cuda)):
        with pytest.raises(ValueError):
            bwd(pd, ts, ct, ct, 1, stage_cycles=cycles)
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
    with pytest.raises(ValueError):     # not 16-byte aligned
        k3(torch.zeros(21, device=cuda)[1:].view(10, 2), ids, 4)


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


def _small_train_scene(device, overrides=()):
    from gsavatar_torch.config import load_config
    from gsavatar_torch.scene import Scene
    cfg = load_config(SMALL + ["dataset.n_target_gaussians=512",
                               "opt.skinning_pool_size=2048",
                               "opt.n_reg_pts=128"] + list(overrides))
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


# the model variants of chip_smoke.py's phase 12, at their published widths
VARIANTS = {
    'mlp': ['non_rigid=mlp'],
    'hannw_sh': ['non_rigid=hannw_mlp', 'texture=sh'],
    'smpl_nn': ['rigid=smpl_nn'],
    'distill': ['model.deformer.rigid.distill=true'],
    '3dgs': ['texture=sh', 'non_rigid=identity', 'rigid=identity',
             'pose_correction=none'],
    'wide_tex': ['texture=mlp'],
}


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_small_variant_step_on_the_card_matches_the_cpu(cuda, variant):
    """One forward and backward of a model variant's training step from
    the same state, camera and draws at iteration 12000 (every gate open,
    SH degree 3 where the arena holds SH): the loss terms, every gradient
    leaf, and the K2 and K3 launches (K3 five times without the hash
    grid's table gradient)."""
    from gsavatar_torch.train import draw, loss_weights, make_grad_fn
    ov = VARIANTS[variant]
    cfg, cpu, cpu_state = _small_train_scene('cpu', ov)
    _, gpu, gpu_state = _small_train_scene(cuda, ov)
    gpu.converter.load_state_dict(cpu.converter.state_dict())
    gpu_state.gauss_params = cpu_state.gauss_params.map(lambda x: x.to(cuda))
    gpu_state.gauss_aux = cpu_state.gauss_aux.map(lambda x: x.to(cuda))
    cam = cpu.train_dataset[0]
    draws = draw(cpu, cpu_state.generator)
    it = 12000
    deg = cpu.active_sh_degree(it)
    w = loss_weights(cfg, it)
    bucket = cpu.bucket_for(int(cpu_state.gauss_aux.alive.sum()))
    counts = (composite.composite_pairs_bwd.launches,
              segsum_blocked.segment_sum_sorted_blocked.launches)
    m_g, _, g_g = make_grad_fn(gpu)(
        gpu_state, cam.to(cuda).replace(image=cam.image.to(cuda),
                                        mask=cam.mask.to(cuda)),
        it, w, draws.to(cuda), deg, bucket, gpu.raster_config)
    torch.cuda.synchronize()
    k3 = 6 if cfg['model']['deformer']['non_rigid']['name'] == 'hashgrid' \
        else 5
    assert composite.composite_pairs_bwd.launches == counts[0] + 1
    assert segsum_blocked.segment_sum_sorted_blocked.launches == counts[1] + k3
    m_c, _, g_c = make_grad_fn(cpu)(cpu_state, cam, it, w, draws, deg,
                                    bucket, cpu.raster_config)
    assert set(m_g) == set(m_c)
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
        assert bool(a.isfinite().all()), name
        if not float(b.abs().max()) > 0.0:
            continue
        rel = float((a - b).abs().mean()) / max(float(b.abs().max()), 1e-3)
        cos = float(a @ b) / (float(a.norm()) * float(b.norm()))
        assert cos > 0.999 and rel < 1e-3, (name, cos, rel)


def test_npz_route_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A small avatar's checkpoint and SMPL npz through
    `InferenceScene.from_smpl_npz` on the card and on the CPU, posed by a
    motion series under a live camera: the render gates."""
    from gsavatar_torch.camera.live import live_camera
    from gsavatar_torch.inference import InferenceScene
    from gsavatar_torch.motion.series import MotionSeries
    cfg, scene, state = _small_train_scene('cpu')
    ckpt = scene.save_checkpoint(state, 100, str(tmp_path))
    npz = str(tmp_path / 'smpl.npz')
    np.savez(npz, minimal_shape=scene.metadata['minimal_shape'])
    rng = np.random.default_rng(0)
    series = MotionSeries({'pose': 0.2 * rng.standard_normal((2, 72))},
                          scene.assets, device='cpu')
    fields = series.camera_pose_fields(1, scene.metadata)
    out = []
    for dev in (cuda, 'cpu'):
        serve = InferenceScene.from_smpl_npz(cfg, ckpt, npz,
                                             assets=scene.assets, device=dev)
        cam = live_camera(np.eye(3), [0.0, 0.0, 2.5], width=64, height=64,
                          rots=fields[0], Jtrs=fields[1],
                          bone_transforms=fields[2], device=dev)
        out.append(serve.render_frame(cam))
    a, b = out
    assert a.pair_overflow == 0 and b.n_pairs > 0
    assert float(b.opacity_render.mean()) > 0.01
    for x, y in ((a.render.clamp(0, 1), b.render.clamp(0, 1)),
                 (a.opacity_render, b.opacity_render)):
        d = (x.double().cpu() - y.double()).abs()
        assert float(d.mean()) < 1e-4
        assert float((d > 1e-2).double().mean()) < 1e-3


@pytest.mark.parametrize('shape,hw', [((540, 540, 3), (1080, 1080)),
                                      ((540, 540, 1), (1080, 1080)),
                                      ((37, 53, 3), (100, 77)),
                                      ((128, 128), (64, 64))])
def test_float_resize_and_composite_on_the_card_equal_the_cpu(cuda, shape,
                                                              hw):
    from gsavatar_torch.apps.body_replace import composite_frame
    from gsavatar_torch.data.image_ops import resize_linear
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.random(shape, dtype=np.float32))
    assert torch.equal(resize_linear(x.to(cuda), hw).cpu(),
                       resize_linear(x, hw))
    render = torch.from_numpy(rng.random(shape[:2] + (3,), dtype=np.float32))
    alpha = torch.from_numpy(rng.random(shape[:2], dtype=np.float32))
    frame = torch.from_numpy(
        (rng.random(tuple(hw) + (3,)) * 255).astype(np.uint8))
    assert torch.equal(
        composite_frame(render.to(cuda), alpha.to(cuda), frame.to(cuda)).cpu(),
        composite_frame(render, alpha, frame))


def test_small_batch_step_on_the_card_matches_the_cpu(cuda):
    """The forward and backward of one B = 2 step (`parallel.
    frames_per_step`: the mean of two frames' losses) from the same state,
    cameras and draws, past every delay gate: each frame's loss terms, the
    mean loss, and every gradient leaf with each frame's screen-space
    gradient (K1 and K2 twice, K3 twelve times on the card)."""
    from gsavatar_torch.train import draw, loss_weights, make_batch_grad_fn
    cfg, cpu, cpu_state = _small_train_scene('cpu')
    _, gpu, gpu_state = _small_train_scene(cuda)
    gpu.converter.load_state_dict(cpu.converter.state_dict())
    gpu_state.gauss_params = cpu_state.gauss_params.map(lambda x: x.to(cuda))
    gpu_state.gauss_aux = cpu_state.gauss_aux.map(lambda x: x.to(cuda))
    cams = [cpu.train_dataset[i] for i in range(2)]
    draws = [draw(cpu, cpu_state.generator) for _ in cams]
    it = 6000
    w = loss_weights(cfg, it)
    bucket = cpu.bucket_for(int(cpu_state.gauss_aux.alive.sum()))
    counts = (composite.composite_pairs_bwd.launches,
              segsum_blocked.segment_sum_sorted_blocked.launches)
    loss_g, m_g, _, g_g = make_batch_grad_fn(gpu)(
        gpu_state, [c.to(cuda).replace(image=c.image.to(cuda),
                                       mask=c.mask.to(cuda)) for c in cams],
        it, w, [d.to(cuda) for d in draws], 0, bucket, gpu.raster_config)
    torch.cuda.synchronize()
    assert composite.composite_pairs_bwd.launches == counts[0] + 2
    assert segsum_blocked.segment_sum_sorted_blocked.launches == \
        counts[1] + 12
    loss_c, m_c, _, g_c = make_batch_grad_fn(cpu)(
        cpu_state, cams, it, w, draws, 0, bucket, cpu.raster_config)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-4 * abs(float(loss_c))
    for frame_g, frame_c in zip(m_g, m_c):
        for k, v in frame_c.items():
            if k.startswith('loss/') and abs(float(v)) > 1e-9:
                assert abs(float(frame_g[k]) - float(v)) <= \
                    1e-4 * abs(float(v)), k
    leaves = [(k, g_g['conv'][k], v) for k, v in g_c['conv'].items()]
    leaves += [(f, getattr(g_g['gauss'], f), getattr(g_c['gauss'], f))
               for f in ('xyz', 'features_dc', 'features_rest', 'scaling',
                         'rotation', 'opacity')]
    leaves += [(f'means2d {b}', a, c) for b, (a, c) in
               enumerate(zip(g_g['means2d'], g_c['means2d']))]
    for name, a, b in leaves:
        a, b = a.double().cpu().reshape(-1), b.double().reshape(-1)
        if not float(b.abs().max()) > 0.0:
            continue
        rel = float((a - b).abs().mean()) / max(float(b.abs().max()), 1e-3)
        cos = float(a @ b) / (float(a.norm()) * float(b.norm()))
        assert cos > 0.999 and rel < 1e-3, (name, cos, rel)


# a densify (iteration 4) and an opacity reset (iteration 5) in 6 iterations
DRIVER = ["dataset.n_target_gaussians=512", "opt.skinning_pool_size=2048",
          "opt.n_reg_pts=128", "model.gaussian.delay=1",
          "opt.densify_from_iter=2", "opt.densification_interval=4",
          "opt.densify_until_iter=100", "opt.opacity_reset_interval=5",
          "opt.iterations=6", "test_interval=0", "seed=0"]


def test_two_subjects_on_the_card_equal_their_single_runs(cuda, tmp_path):
    """A 2-subject run (`parallel.subjects`) on the card against the two
    single runs with `dataset.seed=i seed=i` on the card: the logged losses,
    the densify counts and the final arenas bit for bit."""
    from gsavatar_torch.config import load_config
    from gsavatar_torch.train import training
    cfg = load_config(SMALL + DRIVER + [
        "parallel.subjects=[{'seed': 0}, {'seed': 1}]",
        f"exp_dir={tmp_path / 'ms'}"])
    _, states, logger = training(cfg, log_every=1, progress=False,
                                 device=cuda)
    densify = next(r['densify/n_alive'] for r in logger.history
                   if 'densify/n_alive' in r)
    for i, ms_state in enumerate(states):
        single = load_config(SMALL + DRIVER + [
            f"dataset.seed={i}", f"seed={i}", f"exp_dir={tmp_path / str(i)}"])
        _, state, slog = training(single, log_every=1, progress=False,
                                  device=cuda)
        want = [r['loss/total_loss'] for r in slog.history
                if 'loss/total_loss' in r]
        got = [r[f'subject{i}/loss/total_loss'] for r in logger.history
               if f'subject{i}/loss/total_loss' in r]
        assert got == want and len(want) == 6
        assert densify[i] == next(r['densify/n_alive'] for r in slog.history
                                  if 'densify/n_alive' in r)
        for part in ('gauss_params', 'gauss_aux'):
            for k, v in vars(getattr(state, part)).items():
                assert torch.equal(getattr(getattr(ms_state, part), k), v), k


def test_tooling_tree_on_the_card_gives_the_fixture_digests(cuda, tmp_path):
    """chip_smoke.py phase 16's tree built on the card (the mask's Lanczos
    resize and step 4's LBS there, the rest on the host): every digest of
    tests/fixtures/torch_tooling/digests.json, which the CPU tests hold
    to OpenCV's and the JAX package's output."""
    import json
    import os
    import chip_smoke
    with open(os.path.join(chip_smoke.TOOL_FIXTURES, 'digests.json')) as f:
        want = json.load(f)
    recovered = chip_smoke.build_tooling_tree(str(tmp_path), cuda)
    got = chip_smoke.tooling_digests(str(tmp_path), recovered,
                                     chip_smoke.tooling_overlays())
    assert got == want


@pytest.mark.parametrize('lanczos', [False, True], ids=['linear', 'lanczos'])
def test_decode_batch_on_the_card_equals_the_one_frame_path(cuda, tmp_path,
                                                            lanczos):
    """`native.decode_batch` (one thread and four) and a `Prefetcher` on the
    card: each frame and mask equal bit for bit to
    `zju_format.load_image_mask` on the card."""
    from gsavatar_torch import native
    from gsavatar_torch.data import zju_format
    from gsavatar_torch.utils import png
    rng = np.random.default_rng(7)
    K = np.array([[110.0, 0, 48], [0, 112.0, 47], [0, 0, 1]], np.float32)
    D = np.array([-0.2, 0.15, 1e-3, -8e-4, -0.03], np.float32)
    imgs, masks = [], []
    yy, xx = np.mgrid[:96, :96]
    for i in range(5):
        img = np.clip(128 + 60 * np.sin(xx / 7 + i)[..., None]
                      + rng.normal(0, 5, (96, 96, 3)), 0, 255).astype(np.uint8)
        m = ((((xx - 48 - i) / 20) ** 2 + ((yy - 48) / 30) ** 2) < 1)
        imgs.append(str(tmp_path / f'{i}.jpg'))
        masks.append(str(tmp_path / f'{i}.png'))
        native.write_jpeg(imgs[-1], img)
        png.write_png(masks[-1], m.astype(np.uint8) * 255)
    want = [zju_format.load_image_mask(a, b, K, D, (48, 48), False, lanczos,
                                       device=cuda)
            for a, b in zip(imgs, masks)]
    for threads in (1, 4):
        got_i, got_m = native.decode_batch(imgs, masks, K, D, (48, 48), False,
                                           lanczos, n_threads=threads,
                                           device=cuda)
        for j, (wi, wm) in enumerate(want):
            assert torch.equal(got_i[j], wi) and torch.equal(got_m[j], wm)
    pf = native.Prefetcher(imgs, masks, K, D, (48, 48), False, lanczos,
                           n_threads=2, device=cuda)
    try:
        pf.set_schedule([3, 0, 4, 1, 2])
        for want_idx in (3, 0, 4, 1, 2):
            idx, img, mask = pf.next()
            assert idx == want_idx
            assert torch.equal(img, want[idx][0])
            assert torch.equal(mask, want[idx][1])
        assert pf.next() is None
    finally:
        pf.close()


# K5, the converter's optimizer step, at the zju377_full recipe's leaves:
# 129 parameters and 9 subject constants (chip_smoke.zju_converter_leaves)
@pytest.fixture(scope='module')
def zju_leaves():
    import chip_smoke
    return chip_smoke.zju_converter_leaves()


def _k5_case(zju_leaves, device, scale, clip=None, seed=5):
    import chip_smoke
    cfg, params, consts = zju_leaves
    if clip is not None:
        cfg = dict(cfg, opt=dict(cfg['opt'], grad_clip=clip))
    params = {k: v.to(device) for k, v in params.items()}
    grads, frozen = chip_smoke.k5_grads(params, consts, seed, scale)
    return cfg, params, grads, frozen


@pytest.mark.parametrize('clip,scale', [(0.0, 1.0), (0.1, 1e-6)],
                         ids=['no_clip', 'clip_not_reached'])
def test_k5_equals_plain_where_the_norm_scales_nothing(cuda, zju_leaves,
                                                       clip, scale):
    """Without a clip, or with a norm under it, two kernel steps give the
    plain version's parameters and moments bit for bit on the card."""
    import chip_smoke
    case = _k5_case(zju_leaves, cuda, scale, clip)
    kernel = chip_smoke.k5_run(*case, 2, plain=False)
    plain = chip_smoke.k5_run(*case, 2, plain=True)
    if clip:
        assert float(plain[2].max()) < clip
    for k in plain[0]:
        assert torch.equal(kernel[0][k], plain[0][k]), k
        assert torch.equal(kernel[1].mu[k], plain[1].mu[k]), k
        assert torch.equal(kernel[1].nu[k], plain[1].nu[k]), k


def test_k5_with_the_clip_engaged(cuda, zju_leaves):
    """The clip engaged (norm about 2,660 against 0.1): the kernel's norm
    within 1e-6 of the plain version's, the parameters and moments within
    what that gap and the roundings let through (chip_smoke.k5_gaps)."""
    import chip_smoke
    cfg, *rest = case = _k5_case(zju_leaves, cuda, 1.0)
    kernel = chip_smoke.k5_run(*case, 2, plain=False)
    plain = chip_smoke.k5_run(*case, 2, plain=True)
    assert float(plain[2].min()) > 1000 * float(cfg['opt']['grad_clip'])
    delta, worst = chip_smoke.k5_gaps(cfg, kernel, plain)
    assert delta <= chip_smoke.K5_NORM_RTOL, delta
    assert max(worst.values()) <= 1.0, worst


def test_k5_same_bits_on_every_launch(cuda, zju_leaves):
    import chip_smoke
    case = _k5_case(zju_leaves, cuda, 1.0)
    a = chip_smoke.k5_run(*case, 3, plain=False)
    b = chip_smoke.k5_run(*case, 3, plain=False)
    assert torch.equal(a[2], b[2])
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
        assert torch.equal(a[1].mu[k], b[1].mu[k]), k
        assert torch.equal(a[1].nu[k], b[1].nu[k]), k


def test_k5_two_launches_a_step(cuda, zju_leaves):
    """Two launches a step, the tracer's `update/conv_kernel` once a step
    and no host read of the device; the parameters' in-place versions
    advance (the distilled skinning voxel keys its cache on them); the
    table is built again when the state's tensors change."""
    from gsavatar_torch import tracing
    from gsavatar_torch.ops.conv_adam import conv_adam_step
    from gsavatar_torch.scene import ConverterOptimizer
    cfg, params, grads, frozen = _k5_case(zju_leaves, cuda, 1.0)
    opt = ConverterOptimizer(cfg, int(cfg['opt']['iterations']))
    state = opt.init(params)
    versions = [p._version for p in params.values()]
    before = conv_adam_step.launches
    tracing.enable()
    try:
        for i in range(3):
            with tracing.unit(i, 'train/step'):
                assert opt.step(params, grads, state, frozen) is state
    finally:
        tracing.disable()
    torch.cuda.synchronize()
    assert conv_adam_step.launches == before + 6
    counters = tracing.counters()
    assert all(counters[(i, 'update/conv_kernel')] == 1 for i in range(3))
    assert not any(name.startswith('sync/') for _, name in counters)
    assert all(p._version > v for p, v in zip(params.values(), versions))
    table = opt.plan.table
    state = opt.init(params)
    opt.step(params, grads, state, frozen)
    assert opt.plan.table is not table


def test_k5_wrapper_rejects_what_the_kernel_does_not_take(cuda, zju_leaves):
    from gsavatar_torch.scene import ConverterOptimizer
    cfg, params, grads, frozen = _k5_case(zju_leaves, cuda, 1.0)
    name = 'non_rigid.mlp.lin1.weight'
    const = 'pose_correction.posedirs'

    def step(params=params, grads=grads, frozen=frozen):
        opt = ConverterOptimizer(cfg, int(cfg['opt']['iterations']))
        opt.step(params, grads, opt.init(params), frozen)

    step()
    for bad in (dict(grads, **{name: grads[name].double()}),
                dict(grads, **{name: grads[name].t().contiguous().t()}),
                dict(grads, **{name: grads[name].cpu()})):
        with pytest.raises(ValueError):
            step(grads=bad)
    # the right size, but not one flat run: every other float of a wider
    # array, a broadcast column; then the wrong type
    rows, cols = frozen[const].shape
    for bad in (frozen[const].new_zeros(rows, 2 * cols)[:, ::2],
                frozen[const].new_zeros(rows, 1).expand(rows, cols),
                frozen[const].half()):
        bad = dict(frozen, **{const: bad})
        with pytest.raises(ValueError):
            step(frozen=bad)
    with pytest.raises(ValueError):
        step(params=dict(params, **{name: params[name].t()}))
    # the groups' step sizes and decays: N_GROUPS each
    from gsavatar_torch.ops import conv_adam as K5
    ps = list(params.values())
    opt = ConverterOptimizer(cfg, int(cfg['opt']['iterations']))
    state = opt.init(params)
    mu, nu = list(state.mu.values()), list(state.nu.values())
    ids = (0,) * len(ps)
    for steps, decays in (([0.0] * (K5.N_GROUPS - 1), [0.0] * K5.N_GROUPS),
                          ([0.0] * K5.N_GROUPS, [0.0] * (K5.N_GROUPS + 1))):
        with pytest.raises(ValueError, match='step sizes'):
            K5.conv_adam_step(K5.Plan(), ps, mu, nu, list(grads.values()),
                              [], ids, [0.0] * K5.N_ADAM, steps, decays)


# the benchmark's three playback recipes (perfbench/configs/*.json's groups)
GRAPH_RECIPES = {
    'zju377_full': ['pose_correction=direct', 'non_rigid=hashgrid',
                    'rigid=skinning_field', 'texture=shallow_mlp',
                    'option=iter15k'],
    'ps_female3_rigid': ['pose_correction=none', 'non_rigid=identity',
                         'rigid=skinning_field', 'texture=sh',
                         'option=iter30k'],
    'zju377_mlp': ['pose_correction=direct', 'non_rigid=mlp',
                   'rigid=skinning_field', 'texture=mlp', 'option=iter15k'],
}


def _graph_frames(recipe, cuda, n=5):
    """A small avatar of `recipe` on the card, `n` live-camera frames of a
    seeded motion on an orbit through `render_frame` (one tracer unit
    each), the same frames rendered eagerly afterwards by
    `renderer.render`, and the tracer's counters."""
    from gsavatar_torch import tracing
    from gsavatar_torch.camera.live import live_camera
    from gsavatar_torch.inference import synthetic_scene
    from gsavatar_torch.motion.series import MotionSeries
    from gsavatar_torch.renderer import render
    scene, _ = synthetic_scene(SMALL + GRAPH_RECIPES[recipe], seed=0,
                               device=cuda)
    rng = np.random.default_rng(1)
    series = MotionSeries({'pose': 0.2 * rng.standard_normal((n, 72))},
                          scene.assets, device=cuda)
    cams = []
    for k in range(n):
        rots, jtrs, bt = series.camera_pose_fields(k, scene.metadata)
        a = 0.4 * k
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        cams.append(live_camera(R, [0.0, 0.0, 2.5], width=64, height=64,
                                rots=rots, Jtrs=jtrs, bone_transforms=bt,
                                device=cuda))
    tracing.enable()
    kept = []
    for k, cam in enumerate(cams):
        with tracing.unit(k, 'frame'):
            kept.append(scene.render_frame(cam))
    tracing.disable()
    counted = tracing.counters()
    with torch.inference_mode():
        eager = [render(scene.converter, scene.view(), cam, scene.iteration,
                        scene.raster_config, scene.background,
                        nr_cache=scene._nr_cache) for cam in cams]
    return scene, kept, eager, counted


@pytest.mark.parametrize('recipe', sorted(GRAPH_RECIPES))
def test_replayed_converter_frames_equal_eager_frames(cuda, recipe):
    """Frame 1 eager, frame 2 captured, then one replay a frame; every
    package, also one kept while two later frames replayed, holds its own
    frame's positions, colours and image bit for bit."""
    scene, kept, eager, counted = _graph_frames(recipe, cuda)
    assert counted[(0, 'converter/graph_eager')] == 1.0
    assert counted[(1, 'converter/graph_capture')] == 1.0
    for k in range(2, len(kept)):
        assert counted[(k, 'converter/graph_replay')] == 1.0
        assert (k, 'converter/graph_eager') not in counted
    for k, (pkg, ref) in enumerate(zip(kept, eager)):
        for a, b in ((pkg.deformed_gaussians.get_xyz,
                      ref.deformed_gaussians.get_xyz),
                     (pkg.colors, ref.colors), (pkg.render, ref.render),
                     (pkg.opacity_render, ref.opacity_render)):
            assert torch.equal(a, b), (recipe, k)
    assert not torch.equal(kept[2].deformed_gaussians.get_xyz,
                           kept[4].deformed_gaussians.get_xyz)


def test_converter_capture_that_reads_the_device_stays_eager(cuda,
                                                             monkeypatch):
    """A stage that reads a device value on the host cannot be captured:
    the key runs eagerly from then on, the card keeps working, and the
    frames equal the eager ones."""
    from gsavatar_torch.models.texture import ColorMLP
    plain = ColorMLP.forward

    def reads(self, *args, **kw):
        out = plain(self, *args, **kw)
        float(out.sum())
        return out

    monkeypatch.setattr(ColorMLP, 'forward', reads)
    with pytest.warns(UserWarning, match='runs eagerly'):
        scene, kept, eager, counted = _graph_frames('zju377_full', cuda)
    assert counted[(1, 'converter/graph_unsupported')] == 1.0
    for k in range(len(kept)):
        assert counted[(k, 'converter/graph_eager')] == 1.0
        assert torch.equal(kept[k].render, eager[k].render)
    assert not scene.converter_graphs._graphs
