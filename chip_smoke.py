"""On-card smoke test of gsavatar_torch's avatar render path.

    python3 chip_smoke.py

Needs one CUDA GPU and the CUDA toolkit (nvcc); it exits non-zero without
them. Phases, any failure ends the run with a non-zero exit:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel under gsavatar_torch/csrc, with nvcc;
3. main path: the synthetic avatar at the bench shape (540x540, 4096
   template vertices, 50,000 Gaussians in an arena of 131072, the default
   model config, max_pairs 2^21, max_rect 8), weights from the port's own
   seeded initialisation, 20 frames through the `evaluate` render loop
   (`InferenceScene.render_frame`), with every kernel's launch count set to
   0 just before and read just after; then the per-stage times on one frame;
4. kernels against their plain versions on the pair arrays of one real
   frame, with the kernel's time, the plain version's time and the least
   time the card could take for the same work;
5. reference: a small avatar rendered on the card and, through the plain
   path, on the CPU, held to the repository's render gates.

The line before the last is one JSON object with a record per kernel; the
last line is {"ok": true, "device": {...}}."""
from __future__ import annotations

import json
import subprocess
import time

import torch

FRAMES = 20
SEED = 0
SMALL_SHAPE = [
    "dataset.img_hw=[64,64]",
    "dataset.n_verts=512",
    "dataset.n_points=768",
    "dataset.train_frames=[0,2,1]",
    "model.gaussian.capacity=1024",
    "rasterizer.max_pairs=65536",
]
# K1 against its plain version: both compute power, alpha and T with the
# same separately rounded f32 operations, so T and the set of included pairs
# agree; only the colour sums are taken in another order (a sequential sum
# against a matrix product), which moves them by a few ulp of values <= 1
K1_TOL = 1e-5
# the card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int) -> float:
    """Mean device time of `fn()` in ms, CUDA events around `reps` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_timed(fn, reps: int) -> float:
    """Mean host time of `fn()` in ms, each call ended by a device sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / reps


def frame_stages(scene, cam):
    """The render path of one frame, stage by stage, through the port's
    public functions: converter, project, pairs, K1."""
    from gsavatar_torch.models.converter import compute_nr_cache
    from gsavatar_torch.ops.rasterizer import composite, pairs, project
    rc = scene.raster_config
    it = int(scene.cfg['opt']['iterations'])
    gview = scene.view()
    nr_cache = compute_nr_cache(scene.converter, gview)
    cam = cam.to(scene.device)

    def converter():
        return scene.converter(gview, cam, it, nr_cache=nr_cache)

    def proj_of(deformed):
        return project.project(
            deformed.get_xyz, deformed.get_covariance(),
            cam.world_view_transform, cam.full_proj_transform, cam.tanfovx,
            cam.tanfovy, rc.width, rc.height, active=deformed.alive)

    with torch.inference_mode():
        deformed, _, colors = converter()
        proj = proj_of(deformed)
        opac = deformed.get_opacity

        def build():
            return pairs.build_pairs(proj, colors, opac, rc.grid_x,
                                     rc.grid_y, rc.max_pairs,
                                     max_rect=rc.max_rect)

        pa = build()
        ms = {
            'converter': host_timed(converter, 10),
            'project': host_timed(lambda: proj_of(deformed), 10),
            'pairs': host_timed(build, 10),
            'k1': host_timed(lambda: composite.composite_pairs_fwd(
                pa.pair_data, pa.tile_start, rc.grid_x), 10),
        }
    return pa, ms


def k1_work(pair_data, tile_start, grid_x):
    """What K1 must do on these inputs: per (pair, pixel) of every tile,
    the pairs each pixel walks up to and including the one that stops it,
    those of them with power <= 0 (alpha evaluated) and those included."""
    from gsavatar_torch.ops.rasterizer import composite as K
    px, py = K.pixel_coords(tile_start.shape[0] - 1, grid_x,
                            pair_data.device)
    walked = evaluated = included = 0
    bounds = tile_start.tolist()
    for t in range(len(bounds) - 1):
        s, e = bounds[t], bounds[t + 1]
        if e <= s:
            continue
        d = pair_data[s:e]
        dx = d[:, 0:1] - px[t][None]
        dy = d[:, 1:2] - py[t][None]
        power = -0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) \
            - d[:, 3:4] * dx * dy
        alpha = torch.clamp_max(d[:, 8:9] * torch.exp(power), K.MAX_ALPHA)
        skip = (power > 0.0) | (alpha < K.MIN_ALPHA)
        T_after = torch.cumprod(1.0 - torch.where(skip, 0.0, alpha), dim=0)
        stop = (~skip) & (T_after < K.T_STOP)
        # pairs walked: up to the first stopping pair, or all of them
        before_stop = torch.cumsum(stop.int(), dim=0) - stop.int() == 0
        walked += int(before_stop.sum())
        evaluated += int((before_stop & (power <= 0.0)).sum())
        included += int((before_stop & ~skip & ~stop).sum())
    return walked, evaluated, included


def k1_record(pa, grid_x, launches):
    from gsavatar_torch.ops.rasterizer import composite as K
    pd, ts = pa.pair_data, pa.tile_start
    num_tiles = ts.shape[0] - 1
    got = K.composite_pairs_fwd(pd, ts, grid_x)
    want = K.composite_pairs_fwd_plain(pd, ts, grid_x)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    n_off = int((err > K1_TOL).sum())
    log(f"K1 vs plain on {pa.n_pairs} pairs: max abs err {max_err:.3e}, "
        f"mean {mean_err:.3e}, {n_off} values off by > {K1_TOL:g} "
        f"(tolerance {K1_TOL:g}); max by rows: colour "
        f"{float(err[:, 0:3].max()):.3e}, alpha {float(err[:, 3].max()):.3e}, "
        f"final_T {float(err[:, 4].max()):.3e}, zero rows "
        f"{float(err[:, 5:].max()):.3e}")
    if not max_err <= K1_TOL:
        fail(f"K1 disagrees with its plain version: {max_err} > {K1_TOL}")

    ms = timed(lambda: K.composite_pairs_fwd(pd, ts, grid_x), 200)
    plain_ms = timed(lambda: K.composite_pairs_fwd_plain(pd, ts, grid_x), 3)
    walked, evaluated, included = k1_work(pd, ts, grid_x)
    # f32 operations the kernel's arithmetic needs: 12 for dx, dy, power and
    # its test on every walked (pair, pixel); 4 more (exp, opacity product,
    # clamp, alpha test) where power <= 0; 10 more (1 - alpha, T, its test,
    # the weight, three colour multiply-adds) for every included pair
    ops = 12 * walked + 4 * evaluated + 10 * included
    nbytes = pd.numel() * 4 + ts.numel() * 4 + num_tiles * 8 * 256 * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    per_tile = torch.diff(ts)
    log(f"K1 pairs per tile: max {int(per_tile.max())}, mean "
        f"{float(per_tile.float().mean()):.1f}, {num_tiles} tiles")
    log(f"K1 work: {walked} (pair, pixel) walked, {evaluated} evaluated, "
        f"{included} included; {ops} f32 ops, {nbytes} bytes")
    log(f"K1 {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
        f"operations {t_ops:.4f})")
    return {
        'name': 'composite_fwd', 'route': 'cuda',
        'source': 'gsavatar_torch/csrc/composite_fwd.cu',
        'replaces': 'gsavatar/ops/rasterizer/pallas_composite.py:91',
        'launches': launches, 'max_abs_err': max_err, 'ms': ms,
        'plain_ms': plain_ms, 'bound_ms': max(t_bytes, t_ops),
        'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
        'library_ms': None,
    }


def render_gates(got, want, name):
    """bench.py's parity gates: mean error < 1e-4 and a fraction < 1e-3 of
    pixels off by more than 1e-2."""
    d = (got.double().cpu() - want.double().cpu()).abs()
    mean, frac = float(d.mean()), float((d > 1e-2).double().mean())
    log(f"reference {name}: mean err {mean:.3e}, off > 1e-2 {frac:.3e}")
    if not (mean < 1e-4 and frac < 1e-3):
        fail(f"{name} misses the render gates against the CPU reference")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA GPU is available")
    from gsavatar_torch import kernels
    from gsavatar_torch.config import BENCH_OVERRIDES
    from gsavatar_torch.evaluate import evaluate
    from gsavatar_torch.inference import synthetic_scene
    from gsavatar_torch.ops.rasterizer import composite

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(gpu)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    logs = kernels.build(kernels.sources())
    log(f"build: {kernels.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f"  {name}: {line.strip()}")

    # 3. main path at full width
    t0 = time.perf_counter()
    scene, cams = synthetic_scene(BENCH_OVERRIDES, SEED, 'cuda')
    log(f"set-up: {int(scene.gauss_aux.alive.sum())} Gaussians, "
        f"{len(cams)} cameras, {time.perf_counter() - t0:.1f} s")
    counters = {'composite_fwd': composite.composite_pairs_fwd}
    for fn in counters.values():
        fn.launches = 0
    res = evaluate(scene, cams, n_frames=FRAMES, keep_renders=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    later = sorted(res['frame_ms'][1:])
    log(f"main path: {FRAMES} frames, {1000.0 / res['time_ms']:.1f} FPS "
        f"({res['time_ms']:.3f} ms/frame mean without the first, median "
        f"{later[len(later) // 2]:.3f}, max {later[-1]:.3f}, first "
        f"{res['frame_ms'][0]:.1f} ms), pairs per frame "
        f"{min(res['n_pairs'])}..{max(res['n_pairs'])}, rect_dropped "
        f"{max(res['rect_dropped'])}, launches {launches}")
    for name, n in launches.items():
        if n != FRAMES:
            fail(f"{name} launched {n} times in {FRAMES} frames")
    if any(res['pair_overflow']):
        fail(f"pair_overflow {res['pair_overflow']}")
    for i, (img, alpha) in enumerate(zip(res['images'], res['alphas'])):
        if img.shape != (540, 540, 3) or not bool(img.isfinite().all()):
            fail(f"frame {i}: image {tuple(img.shape)} not finite")
        if not (0.0 <= float(img.min()) and float(img.max()) <= 1.0):
            fail(f"frame {i}: image outside [0, 1]")
        if not float(alpha.mean()) > 0.0:
            fail(f"frame {i}: no alpha coverage")
    cover = float(torch.stack(res['alphas']).mean())
    log(f"alpha coverage {cover:.4f}")

    pa, stage_ms = frame_stages(scene, cams[0])
    log("stage ms (host clock, synced, one frame): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items()))

    # 4. kernels against their plain versions
    records = [k1_record(pa, scene.raster_config.grid_x,
                         launches['composite_fwd'])]

    # 5. a small avatar on the card against the CPU's plain path
    small, small_cams = synthetic_scene(SMALL_SHAPE, SEED, 'cuda')
    ref, _ = synthetic_scene(SMALL_SHAPE, SEED, 'cpu')
    for cam in small_cams[:2]:
        a = small.render_frame(cam.to(small.device))
        b = ref.render_frame(cam)
        # the converter's sums run in another order on the two devices, so
        # a splat on a tile border may touch one tile more or less
        log(f"reference pairs: {a.n_pairs} on the card, {b.n_pairs} on the "
            f"CPU")
        if a.pair_overflow or b.pair_overflow or not a.n_pairs > 0 \
                or abs(a.n_pairs - b.n_pairs) > 0.01 * b.n_pairs:
            fail("small avatar: the pair counts disagree")
        render_gates(a.render.clamp(0, 1), b.render.clamp(0, 1), 'image')
        render_gates(a.opacity_render, b.opacity_render, 'alpha')

    log(json.dumps({'kernels': records}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
