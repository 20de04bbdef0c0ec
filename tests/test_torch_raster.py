"""gsavatar_torch's rasterizer against gsavatar's on the CPU: the plain K1
and K2 against the Pallas kernels in interpret mode on the same pair
arrays, the pair build against the JAX pair build, `rasterize` against JAX
`rasterize(backend='xla')` and the float64 golden oracle fixture, and the
gradients of `rasterize` (through `CompositePairs`, K3's plain version and
the `means2d_offset` hook) against `jax.grad` of JAX
`rasterize(backend='pallas_interpret')`.

Tolerances: K1 3e-5 absolute (a running product of (1 - alpha) against the
kernel's exp of a cumulative log1p sum differ in rounding only). K2 1e-4 of
the largest |value| of the same column in the same tile: the same
transmittance difference, amplified by 1 / (1 - alpha) in the suffix term,
and the 256-pixel sums taken in another order. The whole rasterizer is
gated on distribution statistics (mean error < 1e-4 and a fraction < 1e-3
of pixels off by > 1e-2, bench.py's parity gates), and its gradients on
bench.py's gate (mean error < 1e-3 of the largest value, per leaf) plus a
cosine > 0.999, not the per-element max: the sort is unstable, so
Gaussians with equal quantized depth may composite in another order."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_render_gates, close

from gsavatar_torch.ops.rasterizer import RasterizeConfig as TConfig
from gsavatar_torch.ops.rasterizer import rasterize as t_rasterize
from gsavatar_torch.ops.rasterizer.composite import (
    MAX_ALPHA, MIN_ALPHA, T_STOP, _walk, composite_pairs_bwd,
    composite_pairs_bwd_plain, composite_pairs_bwd_scale, composite_pairs_fwd,
    composite_pairs_fwd_plain, pixel_coords)
from gsavatar_torch.ops.rasterizer.pairs import build_pairs as t_build_pairs
from gsavatar_torch.ops.rasterizer.project import project as t_project

from gsavatar.camera.camera import make_camera
from gsavatar.ops.rasterizer import RasterizeConfig as JConfig
from gsavatar.ops.rasterizer import rasterize as j_rasterize
from gsavatar.ops.rasterizer.pairs import build_pairs as j_build_pairs
from gsavatar.ops.rasterizer.pallas_composite import (
    PAIR_LANES, composite_pairs_bwd as j_composite_pairs_bwd,
    composite_pairs_fwd as j_composite_pairs_fwd)
from gsavatar.ops.rasterizer.project import project as j_project
from gsavatar.utils.transforms import covariance_from_scaling_rotation

H = W = 64
GRID = 4
FIX = os.path.join(os.path.dirname(__file__), 'fixtures', 'golden_raster.npz')


def _camera(h=H, w=W):
    return make_camera(R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), fovx=0.8,
                       fovy=0.8, image=np.zeros((h, w, 3), np.float32),
                       mask=np.zeros((h, w), np.float32),
                       rots=np.zeros((1, 24, 9)), Jtrs=np.zeros((1, 24, 3)),
                       bone_transforms=np.tile(np.eye(4), (24, 1, 1)))


def _scene(n, seed=0, scale=0.05):
    """tests/test_pallas_raster.py's random scene, as numpy."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    s = (scale * (0.5 + rng.random((n, 3)))).astype(np.float32)
    cov = np.asarray(covariance_from_scaling_rotation(
        jnp.asarray(s), 1.0, jnp.asarray(q)))
    colors = rng.random((n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, (n, 1)).astype(np.float32)
    return means, colors, opac, cov


def _projections(means, cov, cam):
    args = (means, cov, cam.world_view_transform, cam.full_proj_transform)
    j = j_project(*[jnp.asarray(a) for a in args], cam.tanfovx, cam.tanfovy,
                  W, H)
    t = t_project(*[torch.from_numpy(np.asarray(a)) for a in args],
                  cam.tanfovx, cam.tanfovy, W, H)
    return j, t


@pytest.mark.parametrize('n,seed', [(40, 1), (120, 5)])
def test_plain_k1_matches_pallas_interpret(n, seed):
    means, colors, opac, cov = _scene(n, seed)
    _, tp = _projections(means, cov, _camera())
    pa = t_build_pairs(tp, torch.from_numpy(colors), torch.from_numpy(opac),
                       GRID, GRID, 2 ** 13)
    assert pa.n_pairs > 0 and pa.pair_overflow == 0
    chunk = 32
    pd = np.zeros((pa.n_pairs + chunk, PAIR_LANES), np.float32)
    pd[:pa.n_pairs, :12] = pa.pair_data.numpy()
    want = np.asarray(j_composite_pairs_fwd(
        jnp.asarray(pd), jnp.asarray(pa.tile_start.numpy()),
        num_tiles=GRID * GRID, grid_x=GRID, chunk=chunk, interpret=True))
    got = composite_pairs_fwd(pa.pair_data, pa.tile_start, GRID)
    assert got.shape == (GRID * GRID, 8, 256)
    close(got, want, rtol=0, atol=3e-5)
    assert float(got[:, 3].max()) > 0.5       # some pixels well covered
    np.testing.assert_array_equal(got[:, 5:].numpy(), 0.0)


def tile_column_scale(values, tile_start):
    """|values| (P, C) -> the largest |value| of each row's column in the
    row's tile, per element."""
    ts = np.asarray(tile_start)
    v = np.abs(np.asarray(values))
    out = np.zeros_like(v)
    for t in range(len(ts) - 1):
        if ts[t + 1] > ts[t]:
            out[ts[t]:ts[t + 1]] = v[ts[t]:ts[t + 1]].max(0)
    return out


@pytest.mark.parametrize('n,seed', [(40, 1), (120, 5)])
def test_plain_k2_matches_pallas_interpret(n, seed):
    """The same pair arrays, forward output and cotangents through the plain
    K2 and `composite_pairs_bwd(..., interpret=True)`."""
    means, colors, opac, cov = _scene(n, seed)
    _, tp = _projections(means, cov, _camera())
    pa = t_build_pairs(tp, torch.from_numpy(colors), torch.from_numpy(opac),
                       GRID, GRID, 2 ** 13)
    fwd = composite_pairs_fwd(pa.pair_data, pa.tile_start, GRID)
    ct = np.random.default_rng(seed).uniform(
        -1.0, 1.0, (GRID * GRID, 8, 256)).astype(np.float32)
    got = composite_pairs_bwd(pa.pair_data, pa.tile_start,
                              torch.from_numpy(ct), fwd, GRID)
    chunk = 32
    pd = np.zeros((pa.n_pairs + chunk, PAIR_LANES), np.float32)
    pd[:pa.n_pairs, :12] = pa.pair_data.numpy()
    want = np.asarray(j_composite_pairs_bwd(
        jnp.asarray(pd), jnp.asarray(pa.tile_start.numpy()), jnp.asarray(ct),
        jnp.asarray(fwd.numpy()), num_tiles=GRID * GRID, grid_x=GRID,
        chunk=chunk, interpret=True))[:pa.n_pairs, :12]
    assert got.shape == (pa.n_pairs, 12)
    np.testing.assert_array_equal(got[:, 9:].numpy(), 0.0)
    scale = tile_column_scale(want, pa.tile_start.numpy())
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 1e-4 * scale + 1e-30)
    assert np.abs(want[:, :9]).max(0).min() > 0.0   # every column is live


@pytest.mark.parametrize('n,seed', [(40, 1), (120, 5)])
def test_k2_row_scale_bounds_the_gradient(n, seed):
    """`composite_pairs_bwd_scale`, the yardstick K2 is held to on the card:
    it bounds every |value| of the plain K2, is zero exactly on the rows no
    pixel includes, and the Pallas kernel (a log-space transmittance, other
    sums) lands within 1e-5 of it from the plain K2, row by row (measured
    below 1e-6)."""
    means, colors, opac, cov = _scene(n, seed)
    _, tp = _projections(means, cov, _camera())
    pa = t_build_pairs(tp, torch.from_numpy(colors), torch.from_numpy(opac),
                       GRID, GRID, 2 ** 13)
    fwd = composite_pairs_fwd(pa.pair_data, pa.tile_start, GRID)
    ct = np.random.default_rng(seed).uniform(
        -1.0, 1.0, (GRID * GRID, 8, 256)).astype(np.float32)
    args = (pa.pair_data, pa.tile_start, torch.from_numpy(ct), fwd, GRID)
    got = composite_pairs_bwd(*args).numpy()
    scale = composite_pairs_bwd_scale(*args).numpy()
    assert scale.shape == got.shape and not scale[:, 9:].any()
    np.testing.assert_array_less(np.abs(got), scale * (1 + 1e-6) + 1e-30)
    dead = ~scale[:, :9].any(1)
    assert 0 < dead.sum() < len(dead) and not got[dead].any()
    chunk = 32
    pd = np.zeros((pa.n_pairs + chunk, PAIR_LANES), np.float32)
    pd[:pa.n_pairs, :12] = pa.pair_data.numpy()
    want = np.asarray(j_composite_pairs_bwd(
        jnp.asarray(pd), jnp.asarray(pa.tile_start.numpy()), jnp.asarray(ct),
        jnp.asarray(fwd.numpy()), num_tiles=GRID * GRID, grid_x=GRID,
        chunk=chunk, interpret=True))[:pa.n_pairs, :12]
    assert (np.abs(got - want) <= 1e-5 * scale).all()


K2_SCENES = pytest.mark.parametrize(
    'n,seed,scale', [(200, 0, 0.05), (3000, 1, 0.08)],
    ids=['sparse', 'saturating'])


def _k2_inputs(n, seed, scale):
    """Pair arrays of a random scene, K1's output on them and a random
    cotangent."""
    means, colors, opac, cov = _scene(n, seed, scale)
    _, tp = _projections(means, cov, _camera())
    pa = t_build_pairs(tp, torch.from_numpy(colors), torch.from_numpy(opac),
                       GRID, GRID, 2 ** 15)
    assert pa.n_pairs > 0 and pa.pair_overflow == 0
    fwd = composite_pairs_fwd(pa.pair_data, pa.tile_start, GRID)
    ct = np.random.default_rng(seed).uniform(
        -1.0, 1.0, (GRID * GRID, 8, 256)).astype(np.float32)
    return pa.pair_data, pa.tile_start, torch.from_numpy(ct), fwd


def _k2_kernel_model(pd, ts, ct, fwd, grid_x, batch=None):
    """csrc/composite_bwd.cu's arithmetic in torch, in pd's dtype.
    dL/dalpha_k = T_k (ct.c_k) - (K - Q_k) / max(1 - alpha_k, 1e-6) with
    Q_k = sum_{j<=k} w_j (ct.c_j) and K = ct.acc_out + dT_end final_T; the
    power gradient as sums over the pixels of d_power times 1, dx, dy, dx^2,
    dx dy, dy^2, times the conic at the end. Each (tile, 32-pixel group)
    unit sums its own pixels; the eight units' rows are added in group
    order. With `batch`, a unit's rows after the batch in which all its 32
    pixels have stopped are set to zero, as the kernel leaves them. Returns
    (grad, rows set to zero, nonzero values those zeros replaced)."""
    num_tiles = ts.shape[0] - 1
    px, py = pixel_coords(num_tiles, grid_x, pd.device)
    partial = torch.zeros((8,) + tuple(pd.shape), dtype=pd.dtype)
    bounds = ts.tolist()
    zeroed = lost = 0
    for t in range(num_tiles):
        s, e = bounds[t], bounds[t + 1]
        if e <= s:
            continue
        d = pd[s:e]
        con_a, con_b, con_c = d[:, 2], d[:, 3], d[:, 4]
        dx, dy, alpha, T_before, include = _walk(d, px[t], py[t])
        power = -0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) \
            - d[:, 3:4] * dx * dy
        skip = (power > 0.0) | (alpha < MIN_ALPHA)
        T_after = torch.cumprod(1.0 - torch.where(skip, 0.0, alpha), dim=0)
        stops = ~skip & (T_after < T_STOP)
        w = torch.where(include, alpha * T_before, 0.0)
        ct_rgb = ct[t, 0:3]
        ctc = d[:, 5:8] @ ct_rgb
        Q = torch.cumsum(w * ctc, dim=0)
        K = (ct_rgb * fwd[t, 0:3]).sum(0) + (ct[t, 4] - ct[t, 3]) * fwd[t, 4]
        one_m = torch.clamp_min(1.0 - alpha, 1e-6)
        d_alpha = torch.where(include, T_before * ctc - (K[None] - Q) / one_m,
                              0.0)
        dp = torch.where(alpha < MAX_ALPHA, d_alpha * alpha, 0.0)
        terms = torch.stack([dp, dp * dx, dp * dy, dp * dx * dx, dp * dx * dy,
                             dp * dy * dy, w * ct_rgb[0], w * ct_rgb[1],
                             w * ct_rgb[2]], dim=-1)          # (n, 256, 9)
        for g in range(8):
            cols = slice(32 * g, 32 * g + 32)
            part = terms[:, cols].sum(1)
            st = stops[:, cols]
            if batch is not None and bool(st.any(0).all()):
                # the latest of the 32 pixels' first stopping pair
                last = int(st.int().argmax(0).max())
                live = (last // batch + 1) * batch
                zeroed += max(e - s - live, 0)
                lost += int(part[live:].ne(0).sum())
                part[live:] = 0.0
            out = partial[g, s:e]
            out[:, 0] = -(con_a * part[:, 1]) - con_b * part[:, 2]
            out[:, 1] = -(con_c * part[:, 2]) - con_b * part[:, 1]
            out[:, 2] = -0.5 * part[:, 3]
            out[:, 3] = -part[:, 4]
            out[:, 4] = -0.5 * part[:, 5]
            out[:, 5:8] = part[:, 6:9]
            out[:, 8] = torch.where(part[:, 0] != 0, part[:, 0] / d[:, 8],
                                    0.0)
    grad = partial[0]
    for g in range(1, 8):
        grad = grad + partial[g]
    return grad, zeroed, lost


@K2_SCENES
def test_k2_q_form_matches_plain_in_float64(n, seed, scale):
    """The identity the kernel relies on: the three colour prefixes enter
    dL/dalpha only through Q_k. In float64, the kernel's form (Q_k, K, the
    factored power sums, the units' rows added in order) equals
    `composite_pairs_bwd_plain`'s per-channel form within 1e-12 of each
    value's own scale."""
    args = [x.double() if x.is_floating_point() else x
            for x in _k2_inputs(n, seed, scale)]
    got, _, _ = _k2_kernel_model(*args, GRID)
    want = composite_pairs_bwd_plain(*args, GRID)
    scale = composite_pairs_bwd_scale(*args, GRID)
    assert want.dtype == torch.float64
    assert bool(((got - want).abs() <= 1e-12 * scale).all())
    assert float(want[:, :9].abs().amax(0).min()) > 0.0


@pytest.mark.parametrize('batch', [96, 8])
@K2_SCENES
def test_k2_kernel_model_matches_plain(n, seed, scale, batch):
    """The kernel's partition in f32: per (tile, 32-pixel group) unit, the
    rows after the batch in which every pixel of the unit stopped are left
    zero. Those rows hold nothing (no pixel of the unit includes them), and
    the result is within K2's on-card tolerance (1e-4 of each value's
    scale) of the plain version. The saturating scene stops units early."""
    args = _k2_inputs(n, seed, scale)
    got, zeroed, lost = _k2_kernel_model(*args, GRID, batch=batch)
    want = composite_pairs_bwd_plain(*args, GRID)
    scale = composite_pairs_bwd_scale(*args, GRID)
    assert lost == 0
    assert bool(((got - want).abs() <= 1e-4 * scale).all())
    assert not got[:, 9:].any()
    if seed == 1:
        assert zeroed > 0


def _grad_gate(got, want, name):
    """bench.py's gradient gate and a cosine, for one leaf."""
    a = np.asarray(got, np.float64).ravel()
    b = np.asarray(want, np.float64).ravel()
    rel = np.abs(a - b).mean() / max(np.abs(b).max(), 1e-3)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert rel < 1e-3 and cos > 0.999, (name, rel, cos)


def test_rasterize_gradients_match_jax_pallas_interpret():
    """d(loss)/d(means3d, colours, opacities, cov3d, background,
    means2d_offset) of a weighted sum of the image and the alpha image:
    CompositePairs (plain K2) and the pair gather's K3 against JAX's
    custom VJPs, the screen-space hook in NDC times half the image size."""
    means, colors, opac, cov = _scene(200, 7)
    cam = _camera()
    rng = np.random.default_rng(11)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    ct_img = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    ct_alpha = rng.uniform(-1, 1, (H, W)).astype(np.float32)
    offset = np.zeros((200, 2), np.float32)
    mats = [np.asarray(cam.world_view_transform),
            np.asarray(cam.full_proj_transform)]
    jcfg = JConfig(width=W, height=H, max_pairs=2 ** 13, chunk=32,
                   backend='pallas_interpret')

    def j_loss(m, c, o, cv, b, off):
        res = j_rasterize(m, c, o, cv, viewmatrix=jnp.asarray(mats[0]),
                          full_projmatrix=jnp.asarray(mats[1]),
                          tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
                          background=b, config=jcfg, means2d_offset=off)
        return (jnp.sum(res.image * ct_img)
                + jnp.sum(res.alpha * ct_alpha))

    args = (means, colors, opac, cov, bg, offset)
    want = jax.jit(jax.grad(j_loss, argnums=tuple(range(6))))(
        *[jnp.asarray(a) for a in args])
    t_args = [torch.from_numpy(np.asarray(a)).requires_grad_()
              for a in args]
    m, c, o, cv, b, off = t_args
    res = t_rasterize(m, c, o, cv,
                      viewmatrix=torch.from_numpy(mats[0]),
                      full_projmatrix=torch.from_numpy(mats[1]),
                      tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, background=b,
                      config=TConfig(width=W, height=H, max_pairs=2 ** 13),
                      means2d_offset=off)
    loss = (res.image * torch.from_numpy(ct_img)).sum() \
        + (res.alpha * torch.from_numpy(ct_alpha)).sum()
    got = torch.autograd.grad(loss, t_args)
    names = ('means3d', 'colors', 'opacities', 'cov3d', 'background',
             'means2d_offset')
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        _grad_gate(g.numpy(), w, name)
    assert np.abs(np.asarray(want[5])).max() > 0.0


def test_plain_k1_stops_below_transmittance_floor():
    """Ten opaque splats on one pixel: the pair that would take T below
    1e-4 and every pair after it are excluded."""
    row = [8.0, 8.0, 1.0, 0.0, 1.0, 1.0, 0.5, 0.25, 0.99, 0.0, 0.0, 0.0]
    pair_data = torch.tensor([row] * 10)
    tile_start = torch.tensor([0, 10], dtype=torch.int32)
    out = composite_pairs_fwd_plain(pair_data, tile_start, 1)
    pix = 8 * 16 + 8
    # the sequential definition, in f32
    a = np.float32(0.99)
    T, acc, kept = np.float32(1.0), np.float32(0.0), 0
    for _ in range(10):
        test_T = T * (np.float32(1.0) - a)
        if test_T < np.float32(1e-4):
            break
        acc += a * T
        T = test_T
        kept += 1
    assert 0 < kept < 10
    close(out[0, 4, pix], T, 1e-6, 0)
    close(out[0, 0, pix], acc, 1e-6, 0)
    close(out[0, 3, pix], 1.0 - T, 1e-6, 0)


@pytest.mark.parametrize('max_pairs,max_rect', [(2 ** 13, 8), (150, 2)],
                         ids=['roomy', 'clamped_and_overflowing'])
def test_build_pairs_matches_jax(max_pairs, max_rect):
    """Same tile ranges, same sorted keys, the same Gaussians in every tile,
    the same counters (pair_overflow, rect_dropped)."""
    means, colors, opac, cov = _scene(60, 3, scale=0.12)
    jp, tp = _projections(means, cov, _camera())
    # jitted: op-by-op dispatch compiles every op on its own, ~10x slower
    jpa = jax.jit(lambda p, c, o: j_build_pairs(
        p, c, o, GRID, GRID, max_pairs, max_rect=max_rect))(
        jp, jnp.asarray(colors), jnp.asarray(opac))
    tpa = t_build_pairs(tp, torch.from_numpy(colors), torch.from_numpy(opac),
                        GRID, GRID, max_pairs, max_rect=max_rect)
    assert tpa.n_pairs == int(jpa.n_pairs)
    assert tpa.pair_overflow == int(jpa.pair_overflow)
    assert tpa.rect_dropped == int(jpa.rect_dropped)
    if max_rect == 2:
        assert tpa.pair_overflow > 0 and tpa.rect_dropped > 0
    ts = np.asarray(jpa.tile_start)
    np.testing.assert_array_equal(tpa.tile_start.numpy(), ts)
    jg = np.asarray(jpa.pair_gauss)
    for t in range(GRID * GRID):
        s, e = ts[t], ts[t + 1]
        assert sorted(tpa.pair_gauss[s:e].tolist()) == sorted(jg[s:e]), t
    # each row carries its Gaussian's data
    tile_of_row = np.repeat(np.arange(GRID * GRID), np.diff(ts))
    order_t = np.lexsort((tpa.pair_gauss.numpy(), tile_of_row))
    order_j = np.lexsort((jg[:tpa.n_pairs], tile_of_row))
    close(tpa.pair_data.numpy()[order_t],
          np.asarray(jpa.pair_data)[:tpa.n_pairs][order_j], 1e-6, 1e-6)


def _raster_both(means, colors, opac, cov, cam, bg, max_pairs=2 ** 13):
    kw = dict(viewmatrix=cam.world_view_transform,
              full_projmatrix=cam.full_proj_transform, tanfovx=cam.tanfovx,
              tanfovy=cam.tanfovy)
    jcfg = JConfig(width=cam.width, height=cam.height, max_pairs=max_pairs,
                   per_tile_capacity=256, chunk=32, backend='xla')
    jres = jax.jit(lambda m, c, o, cv, b, vm, pm: j_rasterize(
        m, c, o, cv, viewmatrix=vm, full_projmatrix=pm, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, background=b, config=jcfg))(
        *[jnp.asarray(a) for a in (means, colors, opac, cov, bg,
                                   kw['viewmatrix'], kw['full_projmatrix'])])
    tres = t_rasterize(
        torch.from_numpy(means), torch.from_numpy(colors),
        torch.from_numpy(opac), torch.from_numpy(np.asarray(cov)),
        background=torch.from_numpy(bg),
        config=TConfig(width=cam.width, height=cam.height,
                       max_pairs=max_pairs),
        **{k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
           else v for k, v in kw.items()})
    return jres, tres


def test_rasterize_matches_jax_xla():
    means, colors, opac, cov = _scene(200, 7)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    jres, tres = _raster_both(means, colors, opac, cov, _camera(), bg)
    assert tres.pair_overflow == 0 and int(jres.pair_overflow) == 0
    assert_render_gates(tres.image.numpy(), jres.image, 'image')
    assert_render_gates(tres.alpha.numpy(), jres.alpha, 'alpha')
    np.testing.assert_array_equal(tres.radii.numpy(), np.asarray(jres.radii))
    assert int(tres.max_rect_side) == int(jres.max_rect_side)
    assert float(tres.alpha.mean()) > 0.1


def test_rasterize_matches_golden_oracle():
    g = dict(np.load(FIX))
    f = lambda k: torch.from_numpy(np.asarray(g[k], np.float32))
    res = t_rasterize(
        f('means3d'), f('colors'), f('opacities'), f('cov3d'),
        viewmatrix=f('viewmatrix'), full_projmatrix=f('full_projmatrix'),
        tanfovx=float(g['tanfovx']), tanfovy=float(g['tanfovy']),
        background=f('background'),
        config=TConfig(width=int(g['width']), height=int(g['height']),
                       max_pairs=2 ** 14))
    assert res.pair_overflow == 0 and res.rect_dropped == 0
    assert_render_gates(res.image.numpy(), g['image'], 'image')
    assert_render_gates(res.alpha.numpy(), g['alpha'], 'alpha')
    np.testing.assert_array_equal(res.radii.numpy(),
                                  g['radii'].astype(np.int32))
