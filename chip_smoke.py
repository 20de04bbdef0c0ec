"""On-card smoke test of gsavatar_torch: the avatar render path, the
training step, the full training run with evaluation, the narrow-row
probe, the real-format data path, the model variants, the serving apps,
multi-subject training with B frames per step, and the ('data', 'model')
mesh over torch.distributed.

    python3 chip_smoke.py

Needs one CUDA GPU and the CUDA toolkit (nvcc); it exits non-zero without
them. Phases, any failure ends the run with a non-zero exit:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel under gsavatar_torch/csrc, with nvcc;
3. render path: the synthetic avatar at the bench shape (540x540, 4096
   template vertices, 50,000 Gaussians in an arena of 131072, the default
   model config, max_pairs 2^21, max_rect 8), weights from the port's own
   seeded initialisation, 20 frames through the `evaluate` render loop
   (`InferenceScene.render_frame`), with every kernel's launch count set to
   0 just before and read just after; then the per-stage times on one frame;
4. K1 against its plain version on the pair arrays of one real frame
   (alpha and final_T equal, colour within K1_TOL), with the kernel's time,
   the plain version's time, the least time the card could take for the
   same work, the (pair, pixel) walked in the fullest tile and the time of
   that tile alone;
5. render reference: a small avatar rendered on the card and, through the
   plain path, on the CPU, held to the repository's render gates;
6. training path: the same avatar and shape through `Scene` and
   `train.make_train_step` (the default config's losses, LPIPS included,
   the converter's optimizer, the arena Adam, the densify statistics),
   30 steps cycling the training cameras, with the launch counts set to 0
   just before and read just after; then the determinism probe: one more
   full-width forward and backward twice on the same state and draws (the
   gradient leaves that differ bit for bit; any difference fails), then
   once under `torch.use_deterministic_algorithms(True, warn_only=True)`
   (the operations that warn);
7. K2 and K3 against their plain versions on the inputs of one full-width
   training step (the pair arrays and the real cotangent for K2, launched
   twice for the same bits, with the time of the fullest tile alone and
   the stage that paces it; all six K3 inputs of the step: the hash-table
   backward, the pair-gradient reduction and the four AIAP neighbour
   gathers, each launched twice for the same bits), with their times,
   plain times, bounds and, for K3, the time of `index_add_` on each
   input;
8. training reference: one small training step on the card and on the CPU
   with the same state, camera and draws, loss terms and gradients held to
   bench.py's gates;
9. training run: `train.training` at the same shape for 40 iterations
   (densify at 10, 20 and 30, the opacity reset at 30, validation
   at 20 and 40 on 2 frames a split, checkpoints at 20 and 40,
   `strict_overflow` on), then a run resumed from the iteration-20
   checkpoint for 5 iterations, then `evaluate.predict` on the final
   checkpoint; each driven with the launch counts set to 0 just before and
   read just after, with the densify counts, the densify, neighbour-refresh,
   step and validation times, and checks of the alive prefix, finiteness,
   the overflow counters and the resumed state;
10. K4, the narrow-row probe: its entry point (`tools.profile_narrow_dma.
   main`) with the launch count set to 0 just before and read just after,
   then the kernel against its plain version at P = 2^21 with its time,
   the plain version's, `torch.sum`'s and the bound; then K5, the
   converter's optimizer step, at the zju377_full recipe's 129 leaves and
   9 subject constants: two steps against the plain version on the card
   (the clip engaged), 2 launches a step, the device ms of the kernel pair,
   the plain loop and `torch._fused_adam_` (the yardstick), the host ms
   of a step on both routes and the bound;
11. the real-format data path: the port's JPEG decode, PNG read,
   undistortion and resize of the committed fixture frames
   (tests/fixtures/torch_frames) held to the SHA-256 digests of OpenCV's
   and the JAX package's results, bit for bit; the host's decode time and
   the device's undistort and resize time per frame; then a ZJU-MoCap tree
   under build/ (views 1 and 2 training, 5 testing, 4 frames each, SMPL
   fits from the port's LBS) trained at 512x512 with 50,000 points for 30
   steps of `make_train_step` (launch counts set to 0 just before and read
   just after: K1 30, K2 30, K3 180), its test split evaluated with saved
   frames that decode back equal; then a PeopleSnapshot tree at 1080^2 ->
   540^2 trained 10 steps, scored by `PSEvaluator` (LPIPS-Alex) and its
   rotating_models predict split rendered;
12. the model variants (VARIANTS: the MLP deformer, the Hann-window
   deformer with the SH texture, nearest-vertex skinning, the distilled
   skinning voxel, the plain-3DGS baseline, the wide MLP texture) at the
   bench shape and their published widths: each 10 training steps from
   iteration 12000 (every delay gate open) and 4 frames of `evaluate`,
   with the launch counts set to 0 just before and read just after (K1
   14, K2 10, K3 60, or 50 without the hash grid's table gradient), the
   step median, frame mean and peak memory, the converter's forward
   under the profiler (and the voxel's build, or `nn_index` with the
   share of its indices equal to the CPU's), and a small step of the
   variant on the card against the CPU's;
13. the serving apps: the last checkpoint phase 9 writes (the resumed
   run's) and an SMPL npz of the synthetic body through `InferenceScene.from_smpl_npz` (its render equal
   bit for bit to `from_checkpoint`'s), a seeded CLIFF-format motion of 30
   frames, then each app with the launch counts set to 0 just before and
   read just after: `render_series` (30 frames at 512^2, K1 30, the PNGs
   read back), `body_replace` over the 1080^2 fixture frame (10 frames at
   540^2, K1 10; the float resize and the composite on the card equal to
   the CPU's bit for bit, frame 0 within the render gates of the CPU
   path), the AR loop over the 1024^2 fixture frame with seeded board
   poses (K1 10), and `capture_and_record` (8 frames at 512^2, JPEG and
   PNG) whose tree the ZJU-MoCap loader reads back for 10 training steps
   (K1 10, K2 10, K3 60); every render finite, in [0, 1] and with the
   avatar in view; each app's ms per frame and its split (the LBS,
   `render_frame`, resize and composite, the file writes);
14. multi-subject training and B frames per step, at the bench shape:
   `parallel.subjects` with four synthetic subjects (`dataset.seed` 0-3)
   for 20 iterations (densify at 10, the opacity reset at 15, validation
   at 20 on 1 frame a split, each subject's checkpoint at 20,
   `strict_overflow` on; K1 80 + 8, K2 80, K3 480), then subjects 0 and 3
   alone with the same seeds, equal to theirs in the multi-subject run bit
   for bit (every logged loss and `n_alive`, the densify's alive count,
   the final xyz); `parallel.frames_per_step=2` on `{data: 1, model: 1}`
   for the same 20 iterations (K1 40 + 2, K2 40, K3 240); the
   `{data: 1, model: 1}` route against the plain route for 5 iterations,
   bit for bit; a small B = 2 step on the card against the CPU at the
   gates of phase 8; each run with the launch counts set to 0 just before
   and read just after, and its step median and peak memory;
15. the ('data', 'model') mesh over torch.distributed, at the bench shape
   and phase 14's config: K1 on the bench frame's pairs and K2 on the
   bench step's inputs over the M = 2 and 4 tile ranges of the model
   ranks (`tile_base`), each range against its plain version, the ranges
   put together against the whole launch bit for bit, and each range's
   device ms against the whole launch's; the `{data: 1, model: 1}` route
   at B = 2 with a process group of world size 1 over NCCL against the
   same run without one, bit for bit, for 5 iterations; two ranks that
   share the card over gloo (`torch.multiprocessing.spawn`):
   `{data: 2, model: 1}` and `{data: 1, model: 2}` at B = 2 for 5
   iterations, both ranks' states equal bit for bit after every step and
   each route within the CPU tests' gates of the one-device B = 2 route,
   then four subjects over the two data ranks, subjects 0 and 3 bit-equal
   to their runs alone; exact launches per rank (K1 and K2 once per frame
   the rank renders, K3 six times); two NCCL ranks on separate cards when
   the machine has two GPUs, else one line that says that route did not
   run. Each route's ms per step.

The line before the last is one JSON object with a record per kernel; the
last line is {"ok": true, "device": {...}}."""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import shutil
import subprocess
import tempfile
import time

import torch

FRAMES = 20
TRAIN_STEPS = 30
TRAIN_ITERATION = 1000   # bench.py's loss weights and learning rate
# the kernels' inputs and the small reference step are taken past every
# delay gate (non-rigid 3000, pose correction 5000), where the hash-table
# and pose gradients are not zero
LATE_ITERATION = 6000
SEED = 0
DEVICE = 'cuda'
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
# K1's time on a bench-shape frame when one CTA walked each whole tile
# (NVIDIA H100 80GB HBM3, 700 W), and the time the (tile, 32-pixel group)
# design aims under
K1_ONE_CTA_MS = 1.374
K1_TARGET_MS = 0.35
# K2 against its plain version: the same included pairs, but the 256-pixel
# sums, the colour prefixes and T are rounded in another order, which moves
# a value by some f32 ulps of the magnitudes of the terms it sums, however
# much they cancel: every value within 1e-4 of its own scale
# (composite.composite_pairs_bwd_scale)
K2_TOL = 1e-4
# K2's time on a bench-shape training step's input when one CTA walked each
# whole tile (NVIDIA H100 80GB HBM3, 700 W), and the time the (tile, 32-pixel
# group) design aims under
K2_ONE_CTA_MS = 1.2169
K2_TARGET_MS = 0.40
# K3 against its plain version: the kernel adds in f32 (in a fixed order:
# a shuffle tree per 32 rows, then the tiles and chunks in order), so each
# segment is held to 1e-5 of the sum of its values' magnitudes; the plain
# version's float64 running sum adds 4 ulps of the largest running sum of
# magnitudes. Two launches on the same input must give the same bits
K3_TOL = 1e-5
# K3 launches per training step, from the code: the pair-gradient
# reduction (pairs.build_pairs), the hash-table gradient
# (hashgrid._HashGather) and the four AIAP neighbour gathers
# (losses.full_aiap_loss: xyz and covariance, canonical and observed)
K3_PER_STEP = 6
# K5 launches of one training step: the clip's norm and the update (every
# configuration clips; a converter with no parameter launches nothing)
K5_PER_STEP = 2
# the small training step on the card against the CPU: each loss term
# within 1e-4 relative; each gradient leaf with cosine > 0.999 and a mean
# error < 1e-3 of its largest value (bench.py's parity gate)
LOSS_RTOL = 1e-4
GRAD_COS = 0.999
GRAD_REL = 1e-3
# phase 9: the training run at the bench shape: densify at 10, 20 and 30,
# the opacity reset at 30, validation at 20 and 40, a checkpoint at 20. The
# densify window closes at 40: a densify there would prune every Gaussian,
# since 10 Adam steps cannot lift an opacity the reset clamped to 0.01 back
# over the 0.05 prune threshold (a logit step of at most opacity_lr each)
DRIVER_ITERATIONS = 40
DRIVER_OVERRIDES = (
    f"opt.iterations={DRIVER_ITERATIONS}", "model.gaussian.delay=0",
    "opt.densify_from_iter=5", "opt.densification_interval=10",
    f"opt.densify_until_iter={DRIVER_ITERATIONS}",
    "opt.opacity_reset_interval=30", "test_interval=20", "max_val_frames=2",
    "checkpoint_iterations=[20]", "strict_overflow=true")
DENSIFY_ROUNDS = 3
RESUME_FROM = 20
RESUME_ITERATIONS = 5
# K4 against its plain version: the 1024 rows of a block added in another
# order, within 1e-5 of the block's sum of |x|
K4_TOL = 1e-5
# the card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# `timed` holds the stream this long per timed call (about 0.2 ms at the
# card's clock), more than any wrapper here takes to launch
SLEEP_CYCLES_PER_CALL = 400_000


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
    """Mean device time of `fn()` in ms: CUDA events around `reps` calls
    after one warm-up call. The calls queue behind a sleep kernel long
    enough for the host to enqueue all of them, so the events see the
    device's work and not the host's launch cost (a small kernel's wrapper
    can take longer on the host than the kernel on the card)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_ms(fn, reps: int) -> float:
    """Mean host time of `fn()` in ms without waiting for the device: what
    a call costs the host thread that launches it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1000.0 / reps
    torch.cuda.synchronize()
    return ms


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
    those of them with power <= 0 (alpha evaluated) and those included;
    and the pairs walked in the fullest tile."""
    from gsavatar_torch.ops.rasterizer import composite as K
    px, py = K.pixel_coords(tile_start.shape[0] - 1, grid_x,
                            pair_data.device)
    walked = evaluated = included = 0
    bounds = tile_start.tolist()
    fullest = max(range(len(bounds) - 1),
                  key=lambda t: bounds[t + 1] - bounds[t])
    fullest_walked = 0
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
        if t == fullest:
            fullest_walked = int(before_stop.sum())
    return walked, evaluated, included, fullest_walked


# the columns of a pair row K1 and K2 read, and of a gradient row K2
# writes: m2dx, m2dy, conic a, b, c, colour r, g, b, opacity
LIVE_COLS = 9


def pairs_bytes(pd, ts):
    """The live columns of each pair row and the tile ranges, read once."""
    return pd.shape[0] * LIVE_COLS * 4 + ts.numel() * 4


def bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations'), t_bytes, t_ops


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
    if not torch.equal(got[:, 3:5], want[:, 3:5]):
        fail("K1's alpha or final_T differs from its plain version")

    ms = timed(lambda: K.composite_pairs_fwd(pd, ts, grid_x), 200)
    plain_ms = timed(lambda: K.composite_pairs_fwd_plain(pd, ts, grid_x), 3)
    walked, evaluated, included, fullest_walked = k1_work(pd, ts, grid_x)
    # f32 operations the kernel's arithmetic needs: 12 for dx, dy, power and
    # its test on every walked (pair, pixel); 4 more (exp, opacity product,
    # clamp, alpha test) where power <= 0; 10 more (1 - alpha, T, its test,
    # the weight, three colour multiply-adds) for every included pair
    ops = 12 * walked + 4 * evaluated + 10 * included
    # plus one (8, 256) f32 tile of output written
    nbytes = pairs_bytes(pd, ts) + num_tiles * 8 * 256 * 4
    b_ms, b_by, t_bytes, t_ops = bound(nbytes, ops)
    per_tile = torch.diff(ts)
    ts_one, _ = fullest_tile_only(ts)
    alone_ms = timed(lambda: K.composite_pairs_fwd(pd, ts_one, grid_x), 200)
    log(f"K1 pairs per tile: max {int(per_tile.max())}, mean "
        f"{float(per_tile.float().mean()):.1f}, {num_tiles} tiles")
    log(f"K1 work: {walked} (pair, pixel) walked, {evaluated} evaluated, "
        f"{included} included; {ops} f32 ops, {nbytes} bytes; "
        f"{fullest_walked} (pair, pixel) walked in the fullest tile "
        f"({int(per_tile.max())} pairs x 256 pixels = "
        f"{int(per_tile.max()) * 256})")
    log(f"K1 {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms "
        f"(bytes {t_bytes:.4f}, operations {t_ops:.4f}); the fullest tile "
        f"alone {alone_ms:.4f} ms; the one-CTA-per-tile design "
        f"{K1_ONE_CTA_MS} ms on a frame of this shape, target <= "
        f"{K1_TARGET_MS} ms")
    return {
        'name': 'composite_fwd', 'route': 'cuda',
        'source': 'gsavatar_torch/csrc/composite_fwd.cu',
        'replaces': 'gsavatar/ops/rasterizer/pallas_composite.py:91',
        'launches': launches, 'max_abs_err': max_err, 'ms': ms,
        'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
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


def small_train_scene(device, ref=None, overrides=()):
    """The SMALL_SHAPE training scene (of the model variant `overrides`)
    on `device`; with `ref` (a scene on another device), its state,
    converter weights and draws' generator copied from `ref` so that the
    two steps see the same inputs."""
    from gsavatar_torch.config import load_config
    from gsavatar_torch.scene import Scene
    cfg = load_config(SMALL_SHAPE + list(overrides))
    scene = Scene(cfg, seed=SEED, device=device)
    state = scene.init_state()
    if ref is not None:
        ref_scene, ref_state = ref
        scene.converter.load_state_dict(ref_scene.converter.state_dict())
        to = lambda x: x.to(device)
        state.gauss_params = ref_state.gauss_params.map(to)
        state.gauss_aux = ref_state.gauss_aux.map(to)
    return cfg, scene, state


def grad_gates(got, want, name):
    """bench.py's gradient gate per leaf: cosine and mean error relative to
    the largest |value|."""
    a, b = got.double().cpu().reshape(-1), want.double().cpu().reshape(-1)
    scale = max(float(b.abs().max()), 1e-3)
    rel = float((a - b).abs().mean()) / scale
    na, nb = float(a.norm()), float(b.norm())
    cos = float(a @ b) / (na * nb) if na > 0 and nb > 0 else (
        1.0 if na == nb else 0.0)
    return cos, rel


def train_reference(overrides=(), iteration=LATE_ITERATION,
                    label='train reference', frames=1):
    """One small training step over `frames` frames (of the model variant
    `overrides`, at `iteration` with its SH degree; the mean of the frames'
    losses) on the card and on the CPU from the same state, cameras and
    draws: each frame's loss terms and the mean loss within LOSS_RTOL,
    every gradient leaf within bench.py's gates."""
    from gsavatar_torch.train import draw, loss_weights, make_batch_grad_fn
    cfg, cpu, cpu_state = small_train_scene('cpu', overrides=overrides)
    _, gpu, gpu_state = small_train_scene(DEVICE, ref=(cpu, cpu_state),
                                          overrides=overrides)
    cams_cpu = [cpu.train_dataset[i] for i in range(frames)]
    cams_gpu = [gpu.train_dataset[i].replace(image=c.image.to(DEVICE),
                                             mask=c.mask.to(DEVICE))
                for i, c in enumerate(cams_cpu)]
    draws = [draw(cpu, cpu_state.generator) for _ in range(frames)]
    w = loss_weights(cfg, iteration)
    deg = cpu.active_sh_degree(iteration)
    bucket = cpu.bucket_for(int(cpu_state.gauss_aux.alive.sum()))
    out = {}
    for name, scene, state, cams in (('cpu', cpu, cpu_state, cams_cpu),
                                     ('gpu', gpu, gpu_state, cams_gpu)):
        out[name] = make_batch_grad_fn(scene)(
            state, cams, iteration, w, [d.to(scene.device) for d in draws],
            deg, bucket, scene.raster_config)
    (loss_c, m_c, _, g_c), (loss_g, m_g, _, g_g) = out['cpu'], out['gpu']
    worst = 0.0
    terms = [('loss', loss_g, loss_c)] + [
        (f'{k} (frame {b})', mg[k], v) for b, (mg, mc) in
        enumerate(zip(m_g, m_c)) for k, v in mc.items()
        if k.startswith('loss/')]
    for k, a, b in terms:
        a, b = float(a), float(b)
        rel = abs(a - b) / max(abs(b), 1e-12)
        worst = max(worst, rel if abs(b) > 1e-9 else 0.0)
        if abs(b) > 1e-9 and rel > LOSS_RTOL:
            fail(f"{label}: {k} {a} on the card, {b} on the CPU")
    leaves = [(f'conv/{k}', g_g['conv'][k], v)
              for k, v in g_c['conv'].items()]
    leaves += [(f'gauss/{f}', getattr(g_g['gauss'], f),
                getattr(g_c['gauss'], f))
               for f in ('xyz', 'features_dc', 'features_rest', 'scaling',
                         'rotation', 'opacity')]
    leaves += [(f'means2d (frame {b})', a, c) for b, (a, c) in
               enumerate(zip(g_g['means2d'], g_c['means2d']))]
    min_cos, max_rel = 1.0, 0.0
    for name, a, b in leaves:
        if not float(b.abs().max()) > 0.0:
            continue      # a leaf this step gives no gradient
        cos, rel = grad_gates(a, b, name)
        min_cos, max_rel = min(min_cos, cos), max(max_rel, rel)
        if not (cos > GRAD_COS and rel < GRAD_REL):
            fail(f"{label} gradient {name}: cosine {cos}, mean rel {rel}")
    log(f"{label}: {len(leaves)} gradient leaves, min cosine "
        f"{min_cos:.7f} (gate > {GRAD_COS}), max mean rel {max_rel:.3e} "
        f"(gate < {GRAD_REL}); loss terms max rel {worst:.3e} (gate < "
        f"{LOSS_RTOL}); pairs {[m['raster/n_pairs'] for m in m_g]} on the "
        f"card, {[m['raster/n_pairs'] for m in m_c]} on the CPU")


def capture_kernel_inputs(scene, state, cam, weights, bucket, draws=None):
    """One more full-width forward and backward (no update; new draws
    unless given), recording the inputs K2 and K3 receive: the metrics, the
    gradients, and the arguments of each launch."""
    import gsavatar_torch.ops.segsum as segsum_mod
    from gsavatar_torch.ops.rasterizer import composite
    from gsavatar_torch.train import draw, make_grad_fn
    seen = {'k2': [], 'k3': []}
    bwd = composite.composite_pairs_bwd
    k3 = segsum_mod.segment_sum_sorted_blocked

    def keep(args):
        return tuple(a.detach() if isinstance(a, torch.Tensor) else a
                     for a in args)

    def rec_bwd(*args):
        seen['k2'].append(keep(args))
        return bwd(*args)

    def rec_k3(*args):
        seen['k3'].append(keep(args))
        return k3(*args)

    # K2's wrapper counts its launches on its module-level name, which is
    # the recorder's while it stands in; these launches come after the
    # training run's counts were read
    rec_bwd.launches = 0
    composite.composite_pairs_bwd = rec_bwd
    segsum_mod.segment_sum_sorted_blocked = rec_k3
    try:
        metrics, _, grads = make_grad_fn(scene)(
            state, cam, LATE_ITERATION, weights,
            draws if draws is not None else draw(scene, state.generator), 0,
            bucket, scene.raster_config)
    finally:
        composite.composite_pairs_bwd = bwd
        segsum_mod.segment_sum_sorted_blocked = k3
    torch.cuda.synchronize()
    return metrics, grads, seen


def _grad_leaves(grads):
    """Every gradient leaf of a grad_fn result, by name."""
    out = {f'conv/{k}': v for k, v in grads['conv'].items()}
    out.update({f'subject/{k}': v for k, v in grads['subject'].items()})
    out.update({f'gauss/{f}': getattr(grads['gauss'], f)
                for f in ('xyz', 'features_dc', 'features_rest', 'scaling',
                          'rotation', 'opacity')})
    out['means2d'] = grads['means2d']
    return out


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def determinism_probe(scene, state, cam, weights, bucket):
    """Whether the full-width step sums in a run-dependent order: its
    forward and backward twice on the same state and draws, with the loss
    terms, the inputs of K2 (the pair rows, K1's output, the cotangent) and
    of K3, and the gradient leaves that differ bit for bit between the two;
    then a third call under torch.use_deterministic_algorithms(True,
    warn_only=True), restored after it, with the operations that warn.
    Fails if the two calls differ."""
    import warnings
    from gsavatar_torch.train import draw
    draws = draw(scene, state.generator)

    def run():
        metrics, grads, seen = capture_kernel_inputs(scene, state, cam,
                                                     weights, bucket, draws)
        return metrics, _grad_leaves(grads), seen

    (ma, ga, sa), (mb, gb, sb) = run(), run()
    diff = {'loss terms': [k for k in ma if k.startswith('loss/')
                           and float(ma[k]) != float(mb[k])],
            'K2 inputs': [n for n, x, y in zip(
                ('pair rows', 'tile ranges', 'cotangent', 'K1 output'),
                sa['k2'][0], sb['k2'][0]) if not _same_bits(x, y)],
            'K3 inputs': [f"{i} ({tuple(x[0].shape)})"
                          for i, (x, y) in enumerate(zip(sa['k3'], sb['k3']))
                          if not all(_same_bits(u, v)
                                     for u, v in zip(x[:2], y[:2]))],
            'gradient leaves': [k for k in ga
                                if not _same_bits(ga[k], gb[k])]}
    log(f"determinism: two calls on the same state and draws differ in "
        + "; ".join(f"{k} {v}" for k, v in diff.items()
                    if k != 'gradient leaves')
        + f"; gradient leaves {len(diff['gradient leaves'])} of {len(ga)} "
        + str(diff['gradient leaves'][:4]))
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            run()
            # an operation that alerts on the card, so that an empty list
            # of the step's warnings means something
            torch.histc(torch.ones(4, device=DEVICE), bins=2)
        finally:
            torch.use_deterministic_algorithms(enabled, warn_only=warn_only)
    msgs = sorted({str(w.message).strip().splitlines()[0][:160]
                   for w in caught})
    log(f"determinism: {len(msgs)} warnings under "
        f"use_deterministic_algorithms(True, warn_only=True), the histc "
        f"check's included" + "".join(f"\n  {m}" for m in msgs))
    # cuDNN's default convolution backward summed in a run-dependent order
    # (ops/conv.py holds it to deterministic algorithms)
    if any(diff.values()):
        fail(f"two calls of the step on the same inputs differ: {diff}")


def train_main():
    """Phase 6: TRAIN_STEPS full-width training steps."""
    from gsavatar_torch.config import BENCH_OVERRIDES, load_config
    from gsavatar_torch.ops import conv_adam, segsum_blocked
    from gsavatar_torch.ops.rasterizer import composite
    from gsavatar_torch.scene import Scene
    from gsavatar_torch.train import loss_weights, make_train_step

    t0 = time.perf_counter()
    cfg = load_config(BENCH_OVERRIDES)
    scene = Scene(cfg, seed=SEED, device=DEVICE)
    state = scene.init_state()
    ds = scene.train_dataset
    cams = [ds[i] for i in range(len(ds))]
    torch.cuda.synchronize()
    n_alive = int(state.gauss_aux.alive.sum())
    bucket = scene.bucket_for(n_alive)
    weights = loss_weights(cfg, TRAIN_ITERATION)
    weights['_in_densify_window'] = 1.0
    xyz_lr = scene.xyz_lr_fn(TRAIN_ITERATION)
    log(f"train set-up: {n_alive} Gaussians (bucket {bucket}), "
        f"{len(cams)} cameras with ground truth, "
        f"{time.perf_counter() - t0:.1f} s")
    step = make_train_step(scene)
    before = {
        'xyz': state.gauss_params.xyz.clone(),
        'features_dc': state.gauss_params.features_dc.clone(),
        'conv': {k: v.detach().clone()
                 for k, v in state.conv_params.items()}}

    counters = {'composite_fwd': composite.composite_pairs_fwd,
                'composite_bwd': composite.composite_pairs_bwd,
                'segsum': segsum_blocked.segment_sum_sorted_blocked,
                'conv_adam': conv_adam.conv_adam_step}
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    step_ms, metrics = [], []
    for i in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        state, m = step(state, cams[i % len(cams)], TRAIN_ITERATION + i,
                        weights, xyz_lr, active_sh_degree=0, bucket=bucket)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1000.0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    later = sorted(step_ms[1:])
    log(f"train path: {TRAIN_STEPS} steps, median {later[len(later) // 2]:.3f}"
        f" ms/step without the first (mean {sum(later) / len(later):.3f}, "
        f"max {later[-1]:.3f}, first {step_ms[0]:.1f}), peak device memory "
        f"{peak:.3f} GiB, pairs per step "
        f"{min(m['raster/n_pairs'] for m in metrics):.0f}.."
        f"{max(m['raster/n_pairs'] for m in metrics):.0f}, launches "
        f"{launches}")
    for label, m in (('first', metrics[0]), ('last', metrics[-1])):
        log(f"train {label} step: " + ", ".join(
            f"{k} {v:.6g}" for k, v in sorted(m.items())))
    for i, m in enumerate(metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            fail(f"train step {i}: non-finite {bad}")
        if m['overflow/pairs']:
            fail(f"train step {i}: pair_overflow {m['overflow/pairs']}")
    first5 = sum(m['loss/total_loss'] for m in metrics[:5]) / 5
    last5 = sum(m['loss/total_loss'] for m in metrics[-5:]) / 5
    log(f"train loss: mean of the first 5 steps {first5:.6f}, of the last "
        f"5 {last5:.6f}")
    if not last5 < first5:
        fail("the training loss did not fall")
    want = {'composite_fwd': TRAIN_STEPS, 'composite_bwd': TRAIN_STEPS,
            'segsum': K3_PER_STEP * TRAIN_STEPS,
            'conv_adam': K5_PER_STEP * TRAIN_STEPS}
    if launches != want:
        fail(f"train launches {launches}, expected {want}")
    # a non-finite gradient element of any step reaches the parameters or
    # the Adam moments (dead slots included: 0 * NaN is NaN)
    tensors = [getattr(t, f) for t in (state.gauss_params, state.gauss_adam.m,
                                       state.gauss_adam.v)
               for f in ('xyz', 'features_dc', 'features_rest', 'scaling',
                         'rotation', 'opacity')]
    tensors += list(state.conv_params.values()) \
        + list(state.conv_opt.mu.values()) + list(state.conv_opt.nu.values()) \
        + [state.gauss_aux.xyz_gradient_accum]
    if not all(bool(t.isfinite().all()) for t in tensors):
        fail("non-finite parameters or optimizer state after training")
    moved = {
        'xyz': float((state.gauss_params.xyz - before['xyz']).abs().max()),
        'features_dc': float((state.gauss_params.features_dc
                              - before['features_dc']).abs().max()),
        'converter': max(float((v.detach() - before['conv'][k]).abs().max())
                         for k, v in state.conv_params.items())}
    log(f"train updates: largest change {moved}")
    if not all(v > 0 for v in moved.values()):
        fail(f"parameters did not change: {moved}")

    _, grads, seen = capture_kernel_inputs(scene, state, cams[0], weights,
                                           bucket)
    leaves = list(_grad_leaves(grads).values())
    if not all(bool(g.isfinite().all()) for g in leaves):
        fail("a gradient leaf of the full-width step is not finite")
    log(f"train gradients: {len(leaves)} leaves, all finite")
    determinism_probe(scene, state, cams[0], weights, bucket)
    return launches, seen


def fullest_tile_only(ts):
    """Tile ranges with every tile but the fullest emptied, and that tile:
    the longest walk, which no split of the work across tiles can shorten."""
    fullest = int(torch.diff(ts).argmax())
    tiles = torch.arange(ts.shape[0], device=ts.device)
    return torch.where(tiles <= fullest, ts[fullest],
                       ts[fullest + 1]).to(torch.int32), fullest


def k2_stages(pd, ts_one, fullest, ct, fwd, grid_x):
    """One K2 launch on the fullest tile alone with the kernel's stage
    clocks: per (tile, 32-pixel group) unit of that tile, the cycles it ran
    and the share of them each stage's warps spent working (the rest they
    waited at the step's barrier); the stage near 1 sets the pace."""
    from gsavatar_torch.ops.rasterizer import composite as K
    n_tiles = ts_one.shape[0] - 1
    cyc = torch.zeros((n_tiles * K.BWD_GROUPS, K.BWD_WARPS, 2),
                      dtype=torch.int64, device=pd.device)
    K.composite_pairs_bwd(pd, ts_one, ct, fwd, grid_x, stage_cycles=cyc)
    torch.cuda.synchronize()
    units = cyc[fullest * K.BWD_GROUPS:(fullest + 1) * K.BWD_GROUPS].cpu()
    n_lanes = (K.BWD_WARPS - 1) // 2
    rows = []
    for g, u in enumerate(units.tolist()):
        total = max(w[1] for w in u)
        busy = [w[0] / max(total, 1) for w in u]
        rows.append((g, total, busy[0], max(busy[1:1 + n_lanes]),
                     max(busy[1 + n_lanes:])))
    for g, total, chain, ev, gr in rows:
        log(f"K2 fullest tile, unit {g}: {total} cycles; busy share chain "
            f"{chain:.3f}, evaluate {ev:.3f}, gradient {gr:.3f}")
    g, total, chain, ev, gr = max(rows, key=lambda r: r[1])
    pace = max((('chain', chain), ('evaluate', ev), ('gradient', gr)),
               key=lambda x: x[1])[0]
    log(f"K2 fullest tile: the longest unit ({g}, {total} cycles) is paced "
        f"by the {pace} stage")
    return pace


def k2_record(args, launches):
    from gsavatar_torch.ops.rasterizer import composite as K
    pd, ts, ct, fwd, grid_x = args
    got = K.composite_pairs_bwd(pd, ts, ct, fwd, grid_x)
    again = K.composite_pairs_bwd(pd, ts, ct, fwd, grid_x)
    want = K.composite_pairs_bwd_plain(pd, ts, ct, fwd, grid_x)
    scale = K.composite_pairs_bwd_scale(pd, ts, ct, fwd, grid_x)
    torch.cuda.synchronize()
    n_tiles = ts.shape[0] - 1
    err = (got - want).abs()
    max_err = float(err.max())
    worst = float((err / scale.clamp_min(1e-30)).max())
    n_off = int((err > K2_TOL * scale).sum())
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        n_diff = int((got.view(torch.int32) != again.view(torch.int32)).sum())
        fail(f"K2 gives other bits on a second launch: {n_diff} values "
             f"differ")
    if got[:, 9:].any():
        fail("K2 wrote columns 9-11")
    log(f"K2 vs plain on {pd.shape[0]} pairs: max abs err {max_err:.3e}, "
        f"worst err / own scale {worst:.3e}, {n_off} values off (tolerance "
        f"{K2_TOL:g} of each value's scale); largest |grad| "
        f"{float(want.abs().max()):.4g}, rows no pixel includes "
        f"{int((scale[:, :9] == 0).all(1).sum())}")
    if n_off:
        r_bad, c_bad = divmod(int((err / scale.clamp_min(1e-30)).argmax()),
                              pd.shape[1])
        log(f"K2 worst row {r_bad} column {c_bad}: kernel "
            f"{float(got[r_bad, c_bad])!r}, plain "
            f"{float(want[r_bad, c_bad])!r}, scale "
            f"{float(scale[r_bad, c_bad])!r}")
        fail(f"K2 disagrees with its plain version: {n_off} values off")
    ms = timed(lambda: K.composite_pairs_bwd(pd, ts, ct, fwd, grid_x), 100)
    plain_ms = timed(lambda: K.composite_pairs_bwd_plain(pd, ts, ct, fwd,
                                                         grid_x), 2)
    ts_one, fullest = fullest_tile_only(ts)
    alone_ms = timed(lambda: K.composite_pairs_bwd(pd, ts_one, ct, fwd,
                                                   grid_x), 100)
    pace = k2_stages(pd, ts_one, fullest, ct, fwd, grid_x)
    walked, evaluated, included, fullest_walked = k1_work(pd, ts, grid_x)
    # f32 operations: the forward's 12 per walked and 4 per evaluated
    # (pair, pixel), and per included one about 54 (T, w, the colour
    # prefixes, dL/dalpha, the nine terms) plus the 9 adds that sum them
    # over the tile's pixels
    ops = 12 * walked + 4 * evaluated + 63 * included
    # bytes: the pair rows' live columns and the tile ranges read, the
    # cotangent's rows 0-4 and the forward output's rows 0-2 and 4 read per
    # tile, the gradient rows' live columns written
    nbytes = pairs_bytes(pd, ts) + n_tiles * (5 + 4) * 256 * 4 \
        + pd.shape[0] * LIVE_COLS * 4
    b_ms, b_by, t_bytes, t_ops = bound(nbytes, ops)
    per_tile = torch.diff(ts)
    log(f"K2 work: {walked} (pair, pixel) walked, {evaluated} evaluated, "
        f"{included} included; {ops} f32 ops, {nbytes} bytes; "
        f"{fullest_walked} (pair, pixel) walked in the fullest tile "
        f"({int(per_tile.max())} pairs x 256 pixels = "
        f"{int(per_tile.max()) * 256}); two launches bit-equal")
    log(f"K2 {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms "
        f"(bytes {t_bytes:.4f}, operations {t_ops:.4f}); the fullest tile "
        f"alone {alone_ms:.4f} ms, paced by the {pace} stage; the "
        f"one-CTA-per-tile design {K2_ONE_CTA_MS} ms on a step of this "
        f"shape, target <= {K2_TARGET_MS} ms")
    return {
        'name': 'composite_bwd', 'route': 'cuda',
        'source': 'gsavatar_torch/csrc/composite_bwd.cu',
        'replaces': 'gsavatar/ops/rasterizer/pallas_composite.py:199',
        'launches': launches, 'max_abs_err': max_err, 'ms': ms,
        'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
        'library_ms': None,
    }


def k3_check(values, ids, num_segments, label):
    """K3 against its plain version on one real input, and launched twice
    for the same bits; returns (max abs err, kernel ms, plain ms,
    index_add_ ms, bound ms, bound_by)."""
    from gsavatar_torch.ops import segsum_blocked as S
    got = S.segment_sum_sorted_blocked(values, ids, num_segments)
    again = S.segment_sum_sorted_blocked(values, ids, num_segments)
    want = S.segment_sum_sorted_blocked_plain(values, ids, num_segments)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        n_diff = int((got.view(torch.int32) != again.view(torch.int32)).sum())
        fail(f"K3 gives other bits on a second launch on {label}: {n_diff} "
             f"values differ")
    mag = S.segment_sum_sorted_blocked_plain(values.abs(), ids, num_segments)
    floor = 4 * torch.finfo(torch.float64).eps * float(
        values.double().abs().sum(0).max())
    torch.cuda.synchronize()
    err = (got - want).abs()
    n_off = int((err > K3_TOL * mag + floor).sum())
    max_err = float(err.max())
    log(f"K3 vs plain, {label}: M {values.shape[0]}, C {values.shape[1]}, "
        f"S {num_segments}: max abs err {max_err:.3e}, worst err / |sum| "
        f"{float((err / mag.clamp_min(1e-30)).max()):.3e}, {n_off} values "
        f"off (tolerance {K3_TOL:g} of the segment's |sum| + {floor:.3g})")
    if n_off:
        s_bad, c_bad = divmod(int((err / mag.clamp_min(1e-30)).argmax()),
                              values.shape[1])
        rows = values[ids == s_bad, c_bad]
        log(f"K3 worst segment {s_bad} column {c_bad}: {rows.numel()} rows, "
            f"kernel {float(got[s_bad, c_bad])!r}, plain "
            f"{float(want[s_bad, c_bad])!r}, float64 sum "
            f"{float(rows.double().sum())!r}, |sum| "
            f"{float(mag[s_bad, c_bad])!r}, rows {rows.tolist()[:64]}")
        fail(f"K3 disagrees with its plain version on {label}")
    kernel = lambda: S.segment_sum_sorted_blocked(values, ids, num_segments)
    library = lambda: torch.zeros(
        (num_segments, values.shape[1]), device=values.device).index_add_(
            0, ids, values)
    ms = timed(kernel, 50)
    plain_ms = timed(lambda: S.segment_sum_sorted_blocked_plain(
        values, ids, num_segments), 3)
    lib_ms = timed(library, 50)
    host_ms, lib_host_ms = enqueue_ms(kernel, 50), enqueue_ms(library, 50)
    M, C = values.shape
    b_ms, b_by, t_bytes, t_ops = bound(M * (4 + 4 * C)
                                       + num_segments * 4 * C, M * C)
    log(f"K3 {label}: {ms:.4f} ms, plain {plain_ms:.3f} ms, index_add_ "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms (bytes {t_bytes:.4f}, "
        f"operations {t_ops:.5f}); two launches bit-equal; host per call "
        f"{host_ms:.4f} ms, index_add_ {lib_host_ms:.4f} ms")
    return max_err, ms, plain_ms, lib_ms, b_ms, b_by


# what each K3 input of a training step sums, by its column count
K3_INPUTS = {2: 'hash table', 9: 'pair gradients', 3: 'AIAP gather, C=3',
             6: 'AIAP gather, C=6'}


def train_phases():
    """Phases 6-8; returns the kernel records of K2 and K3, and K2's
    arguments in the step (phase 15 splits them by tile range)."""
    launches, seen = train_main()
    if len(seen['k2']) != 1 or len(seen['k3']) != K3_PER_STEP:
        fail(f"captured {len(seen['k2'])} K2 and {len(seen['k3'])} K3 "
             f"launches in one step")
    with torch.no_grad():
        records = [k2_record(seen['k2'][0], launches['composite_bwd'])]
        k3 = {}
        for i, (values, ids, n) in enumerate(seen['k3']):
            label = f"{K3_INPUTS[values.shape[1]]} (launch {i + 1} of " \
                f"{K3_PER_STEP})"
            k3[label] = k3_check(values, ids, n, label)
    log("K3 against index_add_ on one step's inputs: " + "; ".join(
        f"{label} {r[1]:.4f} vs {r[3]:.4f} ms" for label, r in k3.items()))
    # the record's times are the hash table's, its error the worst input's
    _, ms, plain_ms, lib_ms, b_ms, b_by = next(
        r for label, r in k3.items() if label.startswith('hash table'))
    max_err = max(r[0] for r in k3.values())
    records.append({
        'name': 'segsum', 'route': 'cuda',
        'source': 'gsavatar_torch/csrc/segsum.cu',
        'replaces': 'gsavatar/ops/segsum_pallas.py:50',
        'launches': launches['segsum'], 'max_abs_err': max_err, 'ms': ms,
        'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
        'library_ms': lib_ms,
    })
    train_reference()
    return records, seen['k2'][0]


def _state_tensors(state):
    """Every tensor of a TrainState and its scalars, by name."""
    from gsavatar_torch.parallel.shard import state_tensors
    out = {k: v.detach() for k, v in state_tensors(state).items()}
    out['generator'] = state.generator.get_state()
    out['step'] = torch.tensor(state.gauss_adam.step)
    out['count'] = torch.tensor(state.conv_opt.count)
    return out


class DriverProbe:
    """Wrappers around the driver's module-level functions that time each
    call on the host clock, ended by a device sync, and check what each
    leaves behind: the step, densify, the neighbour refresh, validation
    and the checkpoint save. Installed for one run, then removed."""

    NAMES = ('make_train_step', 'densify_step', 'refresh_knn',
             'make_validation')

    def __init__(self):
        self.step_ms, self.densify, self.knn_ms = [], [], []
        self.val = []
        self.saved = {}

    def install(self, train_mod, scene):
        self.mod, self.scene = train_mod, scene
        self.orig = {n: getattr(train_mod, n) for n in self.NAMES}
        orig, probe = self.orig, self

        def sync_ms(t0):
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1000.0

        def make_train_step(scene):
            step = orig['make_train_step'](scene)

            def timed_step(state, *a, **k):
                t0 = time.perf_counter()
                out = step(state, *a, **k)
                probe.step_ms.append(sync_ms(t0))
                return out
            return timed_step

        def densify_step(scene, state, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, info = orig['densify_step'](scene, state, *a)
            ms = sync_ms(t0)
            info_h = {k: int(v) for k, v in info.items()}
            alive = state.gauss_aux.alive
            n = info_h['n_alive']
            if not (bool(alive[:n].all()) and not bool(alive[n:].any())):
                fail(f"densify broke the alive prefix ({n} alive)")
            probe.densify.append(dict(info_h, ms=ms,
                                      step=len(probe.step_ms)))
            return state, info

        def refresh_knn(state, bucket):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig['refresh_knn'](state, bucket)
            probe.knn_ms.append((bucket, sync_ms(t0)))
            return out

        def make_validation(scene):
            validation = orig['make_validation'](scene)

            def timed(state, iteration, *a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = validation(state, iteration, *a, **k)
                probe.val.append((iteration, sync_ms(t0), res))
                return res
            return timed

        for n, fn in (('make_train_step', make_train_step),
                      ('densify_step', densify_step),
                      ('refresh_knn', refresh_knn),
                      ('make_validation', make_validation)):
            setattr(train_mod, n, fn)
        save = scene.save_checkpoint

        def save_checkpoint(state, iteration, save_dir):
            probe.saved[iteration] = {k: v.detach().clone() for k, v in
                                      _state_tensors(state).items()}
            return save(state, iteration, save_dir)
        scene.save_checkpoint = save_checkpoint

    def remove(self):
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)
        del self.scene.save_checkpoint


def prerendered(scene):
    """`scene` with its cameras' ground truth rendered already (K1 renders
    it), so that a run's K1 count is its own."""
    for ds in (scene.train_dataset, scene.test_dataset):
        for i in range(len(ds)):
            ds[i]
    torch.cuda.synchronize()
    return scene


def driver_scene(cfg):
    """The training Scene of `cfg`, its ground truth rendered already."""
    from gsavatar_torch.scene import Scene
    return prerendered(Scene(cfg, seed=max(int(cfg.get('seed', -1)), 0),
                             device=DEVICE))


def driven(counters, fn):
    """Run fn() with every kernel's launch count set to 0 just before and
    read just after; returns (fn's result, the counts)."""
    for f in counters.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in counters.items()}


def check_finite_records(logger, label):
    for r in logger.history:
        for k, v in r.items():
            if isinstance(v, float) and not math.isfinite(v):
                fail(f"{label}: non-finite {k} at step {r['step']}")
            if k in ('overflow/pairs', 'overflow/rect') and v:
                fail(f"{label}: {k} {v} at step {r['step']}")


def driver_phase(counters, work):
    """Phase 9: the training run, its files under `work`; returns (its
    config, its probe, its launches)."""
    from gsavatar_torch import train
    from gsavatar_torch.config import BENCH_OVERRIDES, load_config
    cfg = load_config(list(BENCH_OVERRIDES) + list(DRIVER_OVERRIDES)
                      + [f"exp_dir={os.path.join(work, 'run')}"])
    t0 = time.perf_counter()
    scene = driver_scene(cfg)
    log(f"driver set-up: {time.perf_counter() - t0:.1f} s")
    probe = DriverProbe()
    probe.install(train, scene)
    torch.cuda.reset_peak_memory_stats()
    try:
        (scene, state, logger), launches = driven(
            counters, lambda: train.training(cfg, scene=scene, log_every=1,
                                             progress=False))
    finally:
        probe.remove()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_finite_records(logger, 'training run')
    # the frames of one validation: the test split and every (len/10)-th
    # training frame, each capped at max_val_frames
    cap = int(cfg['max_val_frames'])
    n_train = len(scene.train_dataset)
    frames = min(len(scene.test_dataset), cap) + min(
        len(range(0, n_train, max(n_train // 10, 1))), cap)
    if [it for it, _, _ in probe.val] != [20, 40]:
        fail(f"validations at {[it for it, _, _ in probe.val]}")
    val_frames = frames * len(probe.val)
    for it, ms, res in probe.val:
        log(f"validation at {it}: {frames} frames, {ms / frames:.3f} ms per "
            f"frame (host clock, synced), " + ", ".join(
                f"{k} {v:.6g}" for k, v in sorted(res.items())
                if not isinstance(v, list)))
        log(f"validation at {it}: opacity histogram "
            f"{res['val/opacity_histogram']}")
    for d, (bucket, knn_ms) in zip(probe.densify, probe.knn_ms):
        log(f"densify after step {d['step']}: cloned {d['n_cloned']}, split "
            f"{d['n_split']}, pruned {d['n_pruned']}, dropped "
            f"{d['n_dropped']}, alive {d['n_alive']}; {d['ms']:.3f} ms; "
            f"refresh_knn over {bucket} rows {knn_ms:.3f} ms")
    grown = sum(d['n_cloned'] + d['n_split'] for d in probe.densify)
    if len(probe.densify) != DENSIFY_ROUNDS or not grown:
        fail(f"{len(probe.densify)} densify rounds, {grown} Gaussians added")
    steps = probe.step_ms
    before = sorted(steps[1:10])
    after = sorted(steps[30:40])
    log(f"driver steps: {len(steps)}, median {before[len(before) // 2]:.3f} "
        f"ms over steps 2-10 (before any densify), median "
        f"{after[len(after) // 2]:.3f} ms over "
        f"steps 31-40 ({probe.densify[-1]['n_alive']} alive after the last "
        f"densify); first {steps[0]:.1f} ms; peak device memory {peak:.3f} "
        f"GiB")
    want = {'composite_fwd': DRIVER_ITERATIONS + val_frames,
            'composite_bwd': DRIVER_ITERATIONS,
            'segsum': K3_PER_STEP * DRIVER_ITERATIONS, 'narrow_rows': 0,
            'conv_adam': K5_PER_STEP * DRIVER_ITERATIONS}
    log(f"driver launches {launches} (expected {want})")
    if launches != want:
        fail(f"training run launches {launches}, expected {want}")
    final = _state_tensors(state)
    if not all(bool(v.isfinite().all()) for k, v in final.items()
               if v.is_floating_point()):
        fail("non-finite state after the training run")
    ckpt = os.path.join(work, 'run', f'ckpt{RESUME_FROM}.pt')
    if RESUME_FROM not in probe.saved or not os.path.exists(ckpt):
        fail(f"no checkpoint at {RESUME_FROM}")
    return cfg, probe, launches


def resume_and_predict(cfg, work, probe, counters):
    """Phase 9, continued: load the iteration-20 checkpoint (bit for bit
    the saved state), resume from it, and predict from the final one."""
    from gsavatar_torch import train
    from gsavatar_torch.data.synthetic import SyntheticDataset
    from gsavatar_torch.evaluate import predict
    ckpt = os.path.join(work, 'run', f'ckpt{RESUME_FROM}.pt')
    rcfg = dict(cfg, start_checkpoint=ckpt,
                exp_dir=os.path.join(work, 'resume'))
    scene = driver_scene(rcfg)
    loaded, it = scene.load_checkpoint(ckpt)
    got = _state_tensors(loaded)
    saved = probe.saved[RESUME_FROM]
    bad = [k for k in saved if not torch.equal(got[k].cpu(), saved[k].cpu())]
    if it != RESUME_FROM or bad or set(got) != set(saved):
        fail(f"checkpoint {ckpt} loads back different: iteration {it}, "
             f"{bad[:5]}")
    log(f"checkpoint {RESUME_FROM}: {len(saved)} tensors load back bit for "
        f"bit")
    (scene, state, logger), launches = driven(
        counters, lambda: train.training(
            rcfg, scene=scene, log_every=1, progress=False,
            max_iterations=RESUME_FROM + RESUME_ITERATIONS))
    check_finite_records(logger, 'resumed run')
    steps = [r['step'] for r in logger.history if 'loss/total_loss' in r]
    want = {'composite_fwd': RESUME_ITERATIONS,
            'composite_bwd': RESUME_ITERATIONS,
            'segsum': K3_PER_STEP * RESUME_ITERATIONS, 'narrow_rows': 0,
            'conv_adam': K5_PER_STEP * RESUME_ITERATIONS}
    log(f"resumed run: steps {steps}, launches {launches}")
    if steps != list(range(RESUME_FROM + 1,
                           RESUME_FROM + RESUME_ITERATIONS + 1)) \
            or launches != want:
        fail(f"resumed run: steps {steps}, launches {launches}, "
             f"expected {want}")

    pcfg = dict(cfg, mode='test', exp_dir=os.path.join(work, 'run'),
                load_ckpt=os.path.join(work, 'run',
                                       f'ckpt{DRIVER_ITERATIONS}.pt'))
    res, launches = driven(counters, lambda: predict(pcfg))
    n_test = len(SyntheticDataset(pcfg['dataset'], 'test'))
    log(f"predict on ckpt{DRIVER_ITERATIONS}: {n_test} test frames, {res}, "
        f"launches {launches}")
    results = os.path.join(work, 'run', 'eval_view', 'results.npz')
    if not os.path.exists(results) or not all(
            math.isfinite(v) for v in res.values()):
        fail(f"predict: {res}")
    # each test camera: its ground truth (K1) and its render (K1)
    want = {'composite_fwd': 2 * n_test, 'composite_bwd': 0, 'segsum': 0,
            'narrow_rows': 0, 'conv_adam': 0}
    if launches != want:
        fail(f"predict launches {launches}, expected {want}")


def k4_phase(counters):
    """Phase 10: the probe's entry point, then K4 against its plain version
    at P = 2^21."""
    from gsavatar_torch.tools import profile_narrow_dma as K4
    _, launches = driven(counters, K4.main)
    log(f"probe launches {launches}")
    if launches['narrow_rows'] != 21 or any(
            n for k, n in launches.items() if k != 'narrow_rows'):
        fail(f"probe launches {launches}, expected 21 of narrow_rows")
    x = torch.randn((K4.P, K4.COLS), device=DEVICE,
                    generator=torch.Generator(DEVICE).manual_seed(SEED))
    got = K4.run(x)
    want = K4.run_plain(x)
    mag = x.abs().view(-1, K4.BLOCK, K4.COLS).sum(1)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_err = float(err.max())
    n_off = int((err > K4_TOL * mag).sum())
    log(f"K4 vs plain at P {K4.P}: max abs err {max_err:.3e}, worst err / "
        f"sum|x| {float((err / mag).max()):.3e}, {n_off} values off "
        f"(tolerance {K4_TOL:g} of the block's sum of |x|)")
    if n_off:
        fail("K4 disagrees with its plain version")
    ms = timed(lambda: K4.run(x), 200)
    plain_ms = timed(lambda: K4.run_plain(x), 5)
    lib_ms = timed(lambda: x.view(-1, K4.BLOCK, K4.COLS).sum(1), 200)
    nbytes = K4.moved_bytes(K4.P)
    b_ms, b_by, t_bytes, t_ops = bound(nbytes, K4.P * K4.COLS)
    log(f"K4 {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s, "
        f"{nbytes / ms * 1e3 / PEAK_BYTES:.3f} of 3.35 TB/s), plain "
        f"{plain_ms:.3f} ms, torch.sum {lib_ms:.4f} ms "
        f"({nbytes / lib_ms / 1e6:.1f} GB/s), bound {b_ms:.4f} ms (bytes "
        f"{t_bytes:.4f}, operations {t_ops:.5f})")
    return {
        'name': 'narrow_rows', 'route': 'cuda',
        'source': 'gsavatar_torch/csrc/narrow_rows.cu',
        'replaces': 'tools/profile_narrow_dma.py:25',
        'launches': launches['narrow_rows'], 'max_abs_err': max_err,
        'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
        'library_ms': lib_ms,
    }


# K5: the zju377_full recipe's converter (129 leaves, 2,237,865 floats; 9
# subject constants, 4,836,792 floats), from the benchmark's train state:
# zero moments and the count at 5,096
ZJU_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'perfbench', 'configs', 'zju377_full.json')
K5_COUNT = 5096
# the kernel's global norm within this of the plain version's (both sum in
# f32, in other orders)
K5_NORM_RTOL = 1e-6
F32_EPS = 2.0 ** -23


def zju_converter_leaves():
    """The zju377_full recipe's converter, built on the CPU from its
    configuration: (cfg, {name: parameter}, {name: subject constant})."""
    from gsavatar_torch.data import load_dataset
    from gsavatar_torch.models.converter import build_converter
    with open(ZJU_CONFIG) as f:
        cfg = json.load(f)['config']
    ds = load_dataset(cfg['dataset'], 'train', device='cpu')
    conv = build_converter(cfg, ds.metadata, ds.assets)
    return (cfg, {k: p.detach() for k, p in conv.named_parameters()},
            conv.subject_constants())


def k5_grads(params, consts, seed: int, scale: float):
    """Seeded normal gradients times `scale` for the parameters and the
    subject constants, on the parameters' device. The constants' come
    with their dimensions reversed in memory (dense, not contiguous), as
    autograd gives the shape blend's."""
    dev = next(iter(params.values())).device
    gen = torch.Generator(dev).manual_seed(seed)
    draw = lambda shape: scale * torch.randn(shape, generator=gen,
                                             device=dev)
    grads = {k: draw(p.shape) for k, p in params.items()}
    frozen = {k: draw(c.shape[::-1]).permute(*reversed(range(c.ndim)))
              for k, c in consts.items()}
    return grads, frozen


def k5_run(cfg, params, grads, frozen, steps: int, plain: bool):
    """`steps` steps of the converter's optimizer from copies of `params`,
    zero moments and the count K5_COUNT, by the kernel (`step`) or by the
    plain version on the same device (`step_plain`): (params, state, the
    global norm of each step)."""
    from gsavatar_torch.scene import ConverterOptimizer
    opt = ConverterOptimizer(cfg, int(cfg['opt']['iterations']))
    p = {k: v.clone() for k, v in params.items()}
    state = opt.init(p)
    state.count = K5_COUNT
    every = list(grads.values()) + list(frozen.values())
    norms = []
    for _ in range(steps):
        if plain:
            opt.step_plain(p, grads, state, frozen)
            state.count += 1
            norms.append(torch.sqrt(sum((g * g).sum() for g in every)))
        else:
            opt.step(p, grads, state, frozen)
            norms.append(opt.plan.g_norm.clone())
    return p, state, torch.stack(norms)


def k5_gaps(cfg, kernel, plain):
    """The kernel's run against the plain version's, both from `k5_run`:
    (the largest relative gap of the norms, the largest gap of each of the
    parameters, the moments, as a share of what the norm's gap lets
    through). A share up to 1 holds: the first moment moves by the norm's
    gap and four roundings, the second by twice that, and a parameter's
    step (Adam's update hardly moves when its gradient is scaled) by four
    times it and sixteen roundings of the largest step size, plus two
    roundings of the parameter."""
    from gsavatar_torch.scene import ConverterOptimizer
    delta = float(((kernel[2] - plain[2]).abs() / plain[2]).max())
    opt = ConverterOptimizer(cfg, int(cfg['opt']['iterations']))
    step = max(abs(lr) for lr in opt.lr.values())
    worst = {'params': 0.0, 'mu': 0.0, 'nu': 0.0}
    for k in plain[0]:
        for what, a, b, tol in (
                ('params', kernel[0][k], plain[0][k], lambda x: 2 * F32_EPS
                 * x.abs() + step * (4 * delta + 16 * F32_EPS)),
                ('mu', kernel[1].mu[k], plain[1].mu[k],
                 lambda x: (delta + 4 * F32_EPS) * x.abs()),
                ('nu', kernel[1].nu[k], plain[1].nu[k],
                 lambda x: (2 * delta + 6 * F32_EPS) * x.abs())):
            gap = (a - b).abs()
            if gap.numel() and float(gap.max()) > 0:
                share = torch.where(gap > 0, gap / tol(b), 0.0)
                worst[what] = max(worst[what], float(share.max()))
    return delta, worst


def k5_foreach_step(opt, params, grads, state, frozen):
    """`opt.step_plain`'s step in torch's multi-tensor `_foreach_`
    operations (each over every leaf, the clip decided on the device, no
    host read): the stock alternative beside K5, which the port never
    calls. Advances `state.count` as `step` does."""
    from gsavatar_torch.scene import param_group
    names = list(params)
    p = [params[k] for k in names]
    mu = [state.mu[k] for k in names]
    nu = [state.nu[k] for k in names]
    u = [grads[k] for k in names]
    if opt.grad_clip > 0:
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            u + list(frozen.values()))))
        u = torch._foreach_mul(u, torch.where(
            g_norm < opt.grad_clip, 1.0, opt.grad_clip / g_norm))
    groups = [param_group(k) for k in names]
    u = [x + opt.wd[g] * w if opt.wd[g] else x
         for x, w, g in zip(u, p, groups)]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    count = state.count + 1
    bc1 = float(1 - f32(opt.B1) ** count)
    bc2 = float(1 - f32(opt.B2) ** count)
    torch._foreach_mul_(mu, opt.B1)
    torch._foreach_add_(mu, torch._foreach_mul(u, 1 - opt.B1))
    torch._foreach_mul_(nu, opt.B2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(u, u),
                                               1 - opt.B2))
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, opt.EPS)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, [
        float(f32(-opt.lr[g] * opt.gamma ** state.count)) for g in groups])
    torch._foreach_add_(p, upd)
    state.count = count
    return state


def k5_phase(main_launches: int):
    """Phase 10, K5: the converter's optimizer step at the zju377_full
    recipe's leaves; the kernel pair against the plain version on the card
    (two steps with the clip engaged), its launches, then the device ms of
    the pair, of the plain loop, of `k5_foreach_step` and of
    `torch._fused_adam_` on the same parameters (the yardsticks; the port
    calls neither), the host ms of a step on the three routes, and the
    bound. `main_launches`: K5's launches in phase 9's training run, the
    main path's count, which the record reports."""
    from gsavatar_torch.ops.conv_adam import conv_adam_step
    from gsavatar_torch.scene import ConverterOptimizer
    cfg, params, consts = zju_converter_leaves()
    params = {k: v.to(DEVICE) for k, v in params.items()}
    grads, frozen = k5_grads(params, consts, SEED, 1.0)
    before = conv_adam_step.launches
    kernel = k5_run(cfg, params, grads, frozen, 2, plain=False)
    launches = conv_adam_step.launches - before
    plain = k5_run(cfg, params, grads, frozen, 2, plain=True)
    delta, worst = k5_gaps(cfg, kernel, plain)
    torch.cuda.synchronize()
    log(f"K5 vs plain, two steps at {len(params)} leaves and "
        f"{len(consts)} constants: norm {float(plain[2][0]):.6g}, relative "
        f"gap {delta:.3e}; worst gap over its tolerance {worst}; launches "
        f"{launches} (in the training run {main_launches})")
    if launches != 2 * K5_PER_STEP:
        fail(f"K5 launched {launches} times in two steps, expected "
             f"{2 * K5_PER_STEP}")
    if not delta <= K5_NORM_RTOL or max(worst.values()) > 1.0:
        fail("K5 disagrees with its plain version")

    opt = ConverterOptimizer(cfg, int(cfg['opt']['iterations']))
    p = {k: v.clone() for k, v in params.items()}
    state = opt.init(p)
    state.count = K5_COUNT
    step = lambda: opt.step(p, grads, state, frozen)
    plain_step = lambda: opt.step_plain(p, grads, state, frozen)
    foreach_step = lambda: k5_foreach_step(opt, p, grads, state, frozen)
    ms = profiled_device_ms(step, 50)
    plain_ms = profiled_device_ms(plain_step, 5)
    foreach_ms = profiled_device_ms(foreach_step, 20)
    host_ms = enqueue_ms(step, 200)
    plain_host_ms = enqueue_ms(plain_step, 10)
    foreach_host_ms = enqueue_ms(foreach_step, 50)
    leaves = list(p.values())
    steps = [torch.tensor(float(K5_COUNT), device=DEVICE) for _ in leaves]
    lib_ms = profiled_device_ms(lambda: torch._fused_adam_(
        leaves, [grads[k] for k in p], [state.mu[k] for k in p],
        [state.nu[k] for k in p], [], steps, lr=1e-3, beta1=0.9,
        beta2=0.999, weight_decay=0.0, eps=1e-15, amsgrad=False,
        maximize=False), 50)
    n_params = sum(x.numel() for x in leaves)
    n_all = n_params + sum(c.numel() for c in consts.values())
    # the norm reads every gradient; the update reads g, p, mu, nu and
    # writes p, mu, nu
    nbytes = 4 * n_all + 4 * 7 * n_params
    b_ms, b_by, t_bytes, t_ops = bound(nbytes, 2 * n_all + 16 * n_params)
    log(f"K5 {ms:.4f} ms a step on the device ({nbytes / ms / 1e6:.1f} "
        f"GB/s), host {host_ms:.4f} ms; plain {plain_ms:.4f} ms on the "
        f"device, host {plain_host_ms:.3f} ms; _foreach_ {foreach_ms:.4f} "
        f"ms on the device, host {foreach_host_ms:.4f} ms; "
        f"torch._fused_adam_ {lib_ms:.4f} ms (no clip); bound {b_ms:.4f} ms "
        f"(bytes {t_bytes:.4f}, operations {t_ops:.5f}, "
        f"{nbytes / 1e6:.1f} MB)")
    return {
        'name': 'conv_adam', 'route': 'cuda',
        'source': 'gsavatar_torch/csrc/conv_adam.cu',
        'replaces': 'none: optax chain, gsavatar/scene.py',
        'launches': main_launches, 'norm_rel_gap': delta, 'ms': ms,
        'host_ms': host_ms, 'plain_ms': plain_ms,
        'plain_host_ms': plain_host_ms, 'foreach_ms': foreach_ms,
        'foreach_host_ms': foreach_host_ms, 'bound_ms': b_ms,
        'bound_by': b_by, 'library_ms': lib_ms,
    }


# phase 11: the real-format data path. The frames come from
# tests/fixtures/torch_frames (the card has no JPEG or PNG writer); their
# digests.json holds OpenCV's decode and the JAX package's frame path at
# the published sizes, which the port must equal bit for bit
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests',
                        'fixtures', 'torch_frames')
REAL_FRAMES = 4          # frames per view in the trees
ZJU_STEPS = 30
PS_STEPS = 10
DECODE_REPS = 5
# the ZJU tree's cameras: views 1 and 2 train, view 5 tests; each looks at
# the body from 2.5 m, upright, from its own angle about the vertical
ZJU_VIEWS = {'1': 0.0, '2': 0.8, '5': 2.4}


def _sha(x) -> str:
    import numpy as np
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def frame_digests(device):
    """(label, wanted digest, the port's digest) for each fixture frame:
    the decode, the mask's grey read, and `load_image_mask`'s frame and
    mask on `device` at the published size on both backgrounds."""
    import numpy as np
    from gsavatar_torch import native
    from gsavatar_torch.data import zju_format
    with open(os.path.join(FIXTURES, 'digests.json')) as f:
        spec = json.load(f)
    out = []
    for name, rec in spec.items():
        jpg = os.path.join(FIXTURES, rec['jpeg'])
        png = os.path.join(FIXTURES, rec['mask'])
        out.append((f"{name} decode", rec['decoded_sha256'],
                    _sha(native.read_jpeg(jpg))))
        out.append((f"{name} mask read", rec['mask_gray_sha256'],
                    _sha(zju_format.read_image(png, 'gray'))))
        for bg in ('black', 'white'):
            img, msk = zju_format.load_image_mask(
                jpg, png, np.array(rec['K'], np.float32),
                np.array(rec['D'], np.float32), (rec['out'], rec['out']),
                bg == 'white', device=device)
            out.append((f"{name} {bg} frame", rec[bg]['image_sha256'],
                        _sha(img)))
            out.append((f"{name} {bg} mask", rec[bg]['mask_sha256'],
                        _sha(msk)))
    return out


def _smpl_fit(assets, pose, trans):
    import numpy as np
    from gsavatar_torch.smpl import lbs
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    res = lbs.lbs(torch.zeros((1, 10)), t(pose)[None],
                  t(assets.v_template)[None], t(assets.shapedirs),
                  t(assets.posedirs), t(assets.J_regressor), assets.parents,
                  t(assets.skinning_weights))
    return {'minimal_shape': assets.v_template,
            'betas': np.zeros(10, np.float32),
            'bone_transforms': res[3][0].numpy(),
            'trans': np.asarray(trans, np.float32),
            'root_orient': pose[:3], 'pose_body': pose[3:66],
            'pose_hand': pose[66:72]}


def _poses(n, root_orient):
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    out = []
    for _ in range(n):
        p = (0.1 * rng.standard_normal(72)).astype(np.float32)
        p[:3] = root_orient
        out.append(p)
    return out


def build_zju_tree(root):
    """ZJU-MoCap layout: subject S1, views 1 and 2 (training) and 5
    (test), REAL_FRAMES frames each (the 1024^2 fixture frame), SMPL fits
    of the synthetic body from the port's LBS, and cam_params.json."""
    import numpy as np
    from gsavatar_torch.smpl.body_model import find_assets
    with open(os.path.join(FIXTURES, 'digests.json')) as f:
        rec = json.load(f)['zju']
    assets = find_assets(None, 'neutral')
    subj = os.path.join(root, 'S1')
    os.makedirs(os.path.join(subj, 'models'))
    for f, pose in enumerate(_poses(REAL_FRAMES, 0.0)):
        np.savez(os.path.join(subj, 'models', f'{f:06d}.npz'),
                 **_smpl_fit(assets, pose, [0.0, 0.0, 0.0]))
    cams = {}
    flip = np.diag([1.0, -1.0, -1.0])       # y down, looking along -z
    for view, ang in ZJU_VIEWS.items():
        os.makedirs(os.path.join(subj, view))
        for f in range(REAL_FRAMES):
            for src, ext in ((rec['jpeg'], 'jpg'), (rec['mask'], 'png')):
                shutil.copy(os.path.join(FIXTURES, src),
                            os.path.join(subj, view, f'{f:06d}.{ext}'))
        c, s = math.cos(ang), math.sin(ang)
        R = flip @ np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        cams[view] = {'K': rec['K'], 'D': rec['D'], 'R': R.tolist(),
                      'T': [[0.0], [0.0], [2.5]]}
    with open(os.path.join(subj, 'cam_params.json'), 'w') as f:
        json.dump(cams, f)
    return rec


def build_ps_tree(root):
    """PeopleSnapshot layout: subject female-3-casual, REAL_FRAMES frames
    (the 1080^2 fixture frame), animnerf_models, two rotating_models fits
    for the predict split, and camera.pkl. The fits turn the body upright
    and 3 m in front of the camera (PeopleSnapshot's extrinsics are the
    identity)."""
    import pickle
    import numpy as np
    from gsavatar_torch.smpl.body_model import find_assets
    with open(os.path.join(FIXTURES, 'digests.json')) as f:
        rec = json.load(f)['ps']
    assets = find_assets(None, 'female')
    subj = os.path.join(root, 'female-3-casual')
    for d in ('animnerf_models', 'image', 'mask', 'rotating_models'):
        os.makedirs(os.path.join(subj, d))
    upright = [math.pi, 0.0, 0.0]
    for f, pose in enumerate(_poses(REAL_FRAMES, upright)):
        np.savez(os.path.join(subj, 'animnerf_models', f'{f:06d}.npz'),
                 **_smpl_fit(assets, pose, [0.0, 0.0, 3.0]))
        shutil.copy(os.path.join(FIXTURES, rec['jpeg']),
                    os.path.join(subj, 'image', f'{f:06d}.jpg'))
        shutil.copy(os.path.join(FIXTURES, rec['mask']),
                    os.path.join(subj, 'mask', f'{f:06d}.png'))
    for f, pose in enumerate(_poses(2, upright)):
        np.savez(os.path.join(subj, 'rotating_models', f'{f:06d}.npz'),
                 **_smpl_fit(assets, pose, [0.0, 0.0, 3.0]))
    K = rec['K']
    with open(os.path.join(subj, 'camera.pkl'), 'wb') as f:
        pickle.dump({'camera_f': [K[0][0], K[1][1]],
                     'camera_c': [K[0][2], K[1][2]],
                     'camera_k': np.array(rec['D'], np.float32),
                     'height': rec['raw'], 'width': rec['raw']}, f)
    return rec


def profiled_device_ms(fn, reps: int) -> float:
    """Device time of `fn()` in ms per call: the sum of the device
    activity (kernels, copies, fills) the profiler records over `reps`
    calls, after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        fail("the profiler recorded no device activity")
    return sum(e.time_range.end - e.time_range.start
               for e in device) / 1e3 / reps


def data_path_times(gpu):
    """The data path's costs: per frame, the host's decode of the frame
    (JPEG) and its mask (PNG), and the device's part of `load_image_mask`
    on them (undistortion on the view's kept map, resize, background,
    /255); per view, the build of its undistortion map."""
    import numpy as np
    from gsavatar_torch import native
    from gsavatar_torch.data import image_ops, zju_format
    with open(os.path.join(FIXTURES, 'digests.json')) as f:
        spec = json.load(f)
    for name, rec in spec.items():
        jpg = os.path.join(FIXTURES, rec['jpeg'])
        png = os.path.join(FIXTURES, rec['mask'])
        t0 = time.perf_counter()
        for _ in range(DECODE_REPS):
            native.read_jpeg(jpg)
        jpeg_ms = (time.perf_counter() - t0) * 1e3 / DECODE_REPS
        t0 = time.perf_counter()
        for _ in range(DECODE_REPS):
            rgb, gray = zju_format.read_image_mask(jpg, png)
        decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_REPS
        img = torch.as_tensor(rgb, device=DEVICE)
        msk = torch.as_tensor(gray, device=DEVICE)
        K = np.array(rec['K'], np.float32)
        D = np.array(rec['D'], np.float32)
        hw = (rec['out'], rec['out'])

        def frame():
            zju_format.transform_image_mask(img, msk, K, D, hw, False)

        def view_map():
            image_ops.build_undistort_map(K, D, *img.shape[:2], DEVICE)
        dev_ms = profiled_device_ms(frame, 5)
        host_ms = host_timed(frame, 5)
        map_dev_ms = profiled_device_ms(view_map, 3)
        map_host_ms = host_timed(view_map, 3)
        log(f"data path {name} {rec['raw']}^2 -> {rec['out']}^2 ({gpu}): "
            f"host decode {decode_ms:.2f} ms/frame (JPEG alone "
            f"{jpeg_ms:.2f}); transform_image_mask {dev_ms:.3f} device "
            f"ms/frame ({host_ms:.2f} ms/frame host clock, synced); the "
            f"view's undistortion map, built once {map_dev_ms:.3f} device "
            f"ms ({map_host_ms:.2f} ms host clock, synced)")


def real_scene(overrides, label, gpu):
    """A Scene of a real-format config, every training camera loaded
    (the preload), timed."""
    from gsavatar_torch.config import load_config
    from gsavatar_torch.data import image_ops
    from gsavatar_torch.scene import Scene
    cfg = load_config(overrides)
    # the preload builds its views' undistortion maps, as a fresh run does
    image_ops._kept_map.cache_clear()
    t0 = time.perf_counter()
    scene = Scene(cfg, seed=SEED, device=DEVICE)
    t1 = time.perf_counter()
    cams = [scene.train_dataset[i] for i in range(len(scene.train_dataset))]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"{label} ({gpu}): scene set-up {t1 - t0:.2f} s, preload of the "
        f"{len(cams)} training frames {t2 - t1:.2f} s "
        f"({(t2 - t1) / len(cams) * 1e3:.1f} ms/frame), frames "
        f"{tuple(cams[0].image.shape)} on {cams[0].image.device}")
    return cfg, scene, cams


def real_train(scene, cams, steps, counters, label, gpu):
    """`steps` training steps cycling the cameras, with the kernels'
    launch counts set to 0 just before and read just after."""
    from gsavatar_torch.train import loss_weights, make_train_step
    state = scene.init_state()
    n_alive = int(state.gauss_aux.alive.sum())
    bucket = scene.bucket_for(n_alive)
    weights = loss_weights(scene.cfg, TRAIN_ITERATION)
    weights['_in_densify_window'] = 1.0
    xyz_lr = scene.xyz_lr_fn(TRAIN_ITERATION)
    step = make_train_step(scene)
    step_ms, metrics = [], []

    def run():
        nonlocal state
        for i in range(steps):
            t1 = time.perf_counter()
            state, m = step(state, cams[i % len(cams)], TRAIN_ITERATION + i,
                            weights, xyz_lr, active_sh_degree=0,
                            bucket=bucket)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1000.0)
            metrics.append({k: float(v) for k, v in m.items()})
    _, launches = driven(counters, run)
    later = sorted(step_ms[1:])
    log(f"{label} training ({gpu}): {n_alive} Gaussians, {steps} steps, "
        f"median {later[len(later) // 2]:.3f} ms/step without the first "
        f"(first {step_ms[0]:.1f}), loss {metrics[0]['loss/total_loss']:.5f}"
        f" -> {metrics[-1]['loss/total_loss']:.5f}, launches {launches}")
    for i, m in enumerate(metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            fail(f"{label} step {i}: non-finite {bad}")
        if m['overflow/pairs']:
            fail(f"{label} step {i}: pair_overflow {m['overflow/pairs']}")
    want = {'composite_fwd': steps, 'composite_bwd': steps,
            'segsum': K3_PER_STEP * steps, 'narrow_rows': 0,
            'conv_adam': K5_PER_STEP * steps}
    if launches != want:
        fail(f"{label} launches {launches}, expected {want}")
    return state


def real_evaluate(scene, state, cams, evaluator, out_dir, label):
    """Render `cams` from the trained state through `evaluate`, saving the
    frames (and composites): each PNG, decoded by the port, equals the
    frame in memory; results.npz holds every metric, each finite."""
    import numpy as np
    from gsavatar_torch.evaluate import evaluate, to_uint8
    from gsavatar_torch.inference import AvatarState, InferenceScene
    from gsavatar_torch.utils import png
    infer = InferenceScene(
        scene.cfg, scene.metadata, scene.assets,
        AvatarState(state.gauss_params, state.gauss_aux,
                    scene.converter.state_dict()), device=DEVICE,
        iteration=TRAIN_ITERATION)
    res = evaluate(infer, cams, keep_renders=True, evaluator=evaluator,
                   out_dir=out_dir, save_images=True, save_composite=True)
    for cam, img in zip(cams, res['images']):
        got = png.read_png(os.path.join(out_dir, f"{cam.image_name}.png"))
        if not np.array_equal(got, to_uint8(img)):
            fail(f"{label}: {cam.image_name}.png reads back different")
        comp = png.read_png(os.path.join(
            out_dir, f"{cam.image_name}_composite.png"))
        if comp.shape != got.shape:
            fail(f"{label}: {cam.image_name}_composite.png {comp.shape}")
        if not bool(img.isfinite().all()) or not float(img.max()) > 0:
            fail(f"{label}: {cam.image_name} renders empty or non-finite")
    npz = np.load(os.path.join(out_dir, 'results.npz'))
    values = {k: float(npz[k]) for k in npz.files}
    log(f"{label}: {len(cams)} frames saved and read back, results.npz "
        f"{values}")
    want = {'metrics/time_ms'} | ({f'metrics/{k}' for k in res['metrics']}
                                  if evaluator is not None else set())
    if set(values) != want or not all(math.isfinite(v)
                                      for v in values.values()):
        fail(f"{label}: results.npz {values}")
    return res


def real_data_phase(counters, work, gpu):
    """Phase 11: the fixture digests, then training and evaluation on a
    ZJU-MoCap tree at 512^2 and a PeopleSnapshot tree at 540^2."""
    from gsavatar_torch.data import load_dataset
    from gsavatar_torch.metrics import PSEvaluator, get_evaluator
    checks = frame_digests(DEVICE)
    bad = [label for label, want, got in checks if want != got]
    log(f"fixture digests: {len(checks) - len(bad)} of {len(checks)} equal "
        f"(decode, mask read, frame and mask at 512^2 and 540^2 on black "
        f"and white)")
    if bad:
        fail(f"the port's frames differ from OpenCV's: {bad}")
    data_path_times(gpu)

    zju = os.path.join(work, 'zju')
    rec = build_zju_tree(zju)
    cfg, scene, cams = real_scene([
        'dataset=zjumocap_377_mono', f'dataset.root_dir={zju}',
        'dataset.subject=S1', "dataset.train_views=['1','2']",
        "dataset.val_views=['5']", f'dataset.train_frames=[0,{REAL_FRAMES},1]',
        f'dataset.test_frames.view=[0,{REAL_FRAMES},1]',
        'dataset.n_points=50000'], 'ZJU-MoCap tree', gpu)
    if tuple(cams[0].image.shape) != (512, 512, 3):
        fail(f"ZJU frames {tuple(cams[0].image.shape)}")
    # a training camera's frame is the fixture's digest (K is centred)
    if _sha(cams[0].image) != rec['black']['image_sha256']:
        fail("the ZJU loader's frame differs from the fixture's digest")
    state = real_train(scene, cams, ZJU_STEPS, counters, 'ZJU-MoCap', gpu)
    test = load_dataset(cfg['dataset'], 'test', device=DEVICE)
    test = [test[i] for i in range(len(test))]
    if len(test) != REAL_FRAMES:
        fail(f"ZJU test split: {len(test)} frames")
    real_evaluate(scene, state, test, get_evaluator('zjumocap'),
                  os.path.join(work, 'eval_zju'), 'ZJU-MoCap test split')

    ps = os.path.join(work, 'ps')
    build_ps_tree(ps)
    cfg, scene, cams = real_scene([
        'dataset=ps_female_3', f'dataset.root_dir={ps}',
        f'dataset.train_frames=[0,{REAL_FRAMES},1]',
        f'dataset.val_frames=[{REAL_FRAMES - 1},{REAL_FRAMES},1]',
        f'dataset.test_frames.pose=[0,{REAL_FRAMES},2]',
        'dataset.test_mode=pose', 'dataset.n_points=50000'],
        'PeopleSnapshot tree', gpu)
    if tuple(cams[0].image.shape) != (540, 540, 3):
        fail(f"PeopleSnapshot frames {tuple(cams[0].image.shape)}")
    state = real_train(scene, cams, PS_STEPS, counters, 'PeopleSnapshot',
                       gpu)
    test = load_dataset(cfg['dataset'], 'test', device=DEVICE)
    test = [test[i] for i in range(len(test))]
    evaluator = get_evaluator('people_snapshot')
    if not isinstance(evaluator, PSEvaluator):
        fail(f"people_snapshot's evaluator is {type(evaluator).__name__}")
    res = real_evaluate(scene, state, test, evaluator,
                        os.path.join(work, 'eval_ps'),
                        'PeopleSnapshot test split (PSEvaluator, '
                        'LPIPS-Alex)')
    if 'lpips_rand' not in res['metrics'] and 'lpips' not in res['metrics']:
        fail(f"PSEvaluator gave no LPIPS: {res['metrics']}")
    predict = load_dataset(cfg['dataset'], 'predict', device=DEVICE)
    real_evaluate(scene, state, [predict[i] for i in range(len(predict))],
                  None, os.path.join(work, 'predict_ps'),
                  'PeopleSnapshot rotating_models predict split')


# phase 12: the model variants at the bench shape and their published
# widths (the paper's ablations and baselines), each from an iteration
# where every gate is open: the non-rigid delay and the Hann window's
# kick-in (3000), its full band (10000), pose correction (5000), SH degree 3
# (from 3000)
VARIANTS = {
    'v_mlp': ('non_rigid=mlp',),
    'v_hannw_sh': ('non_rigid=hannw_mlp', 'texture=sh'),
    'v_smpl_nn': ('rigid=smpl_nn',),
    'v_distill': ('model.deformer.rigid.distill=true',),
    'v_3dgs': ('texture=sh', 'non_rigid=identity', 'rigid=identity',
               'pose_correction=none'),
    'v_wide_tex': ('texture=mlp',),
}
VARIANT_ITERATION = 12000
VARIANT_STEPS = 10
VARIANT_FRAMES = 4
# nearest-vertex indices that differ between the card and the CPU must be
# ties of the f32 distance |q|^2 + |v|^2 - 2 q.v that both evaluate: its
# rounding moves each of the two distances by up to 8 f32 eps (|q|^2 +
# max |v|^2), however small the distance, so the two exact distances must
# agree within twice that
NN_TIE_EPS = 16 * 2.0 ** -23


def k3_per_step(cfg) -> int:
    """K3 launches of one training step: the pair gradients and the four
    AIAP gathers, and the hash table's gradient under the hash-grid
    deformer."""
    hashgrid = cfg['model']['deformer']['non_rigid']['name'] == 'hashgrid'
    return K3_PER_STEP - (not hashgrid)


def nn_agreement(scene, state, cam, bucket, it):
    """The nearest-vertex indices of the rigid deformer's input (the
    non-rigid deformer's output) on the card and on the CPU: the share that
    agree, and where they differ the worst gap between the two exact
    distances in units of the f32 rounding bound (NN_TIE_EPS): at most 1
    for a tie."""
    from gsavatar_torch.core import gaussians as G
    from gsavatar_torch.ops import knn
    conv = scene.converter
    with torch.no_grad():
        view = G.make_view(state.gauss_params, state.gauss_aux,
                           bucket=bucket)
        xyz, _ = conv.non_rigid(view, cam, it, cam.latent_idx)
        xyz = xyz.get_xyz[state.gauss_aux.alive[:bucket]]
        verts = conv.rigid.smpl_verts
        idx_gpu = knn.nn_index(xyz, verts).long().cpu()
        idx_cpu = knn.nn_index(xyz.cpu(), verts.cpu()).long()
    diff = (idx_gpu != idx_cpu).nonzero()[:, 0]
    q, v = xyz.cpu().double(), verts.cpu().double()
    d_gpu = ((q[diff] - v[idx_gpu[diff]]) ** 2).sum(-1)
    d_cpu = ((q[diff] - v[idx_cpu[diff]]) ** 2).sum(-1)
    bound = NN_TIE_EPS * ((q[diff] ** 2).sum(-1) + (v ** 2).sum(-1).max())
    gap = float(((d_gpu - d_cpu).abs() / bound).max()) if len(diff) else 0.0
    share = 1.0 - len(diff) / len(idx_cpu)
    return share, len(diff), gap, xyz, verts


def variant_run(name, overrides, counters, gpu):
    """VARIANT_STEPS training steps and VARIANT_FRAMES frames of `evaluate`
    of one variant at the bench shape, with the kernels' launch counts set
    to 0 just before and read just after; then its converter's device ms
    under the profiler, and the small step against the CPU's."""
    from gsavatar_torch.config import BENCH_OVERRIDES, load_config
    from gsavatar_torch.data import load_dataset
    from gsavatar_torch.evaluate import evaluate
    from gsavatar_torch.core import gaussians as G
    from gsavatar_torch.inference import AvatarState, InferenceScene
    from gsavatar_torch.ops import knn
    from gsavatar_torch.train import loss_weights, make_train_step
    t0 = time.perf_counter()
    cfg = load_config(list(BENCH_OVERRIDES) + list(overrides))
    scene = driver_scene(cfg)
    state = scene.init_state()
    cams = [scene.train_dataset[i] for i in range(len(scene.train_dataset))]
    predict = load_dataset(cfg['dataset'], 'predict', ground_truth=False)
    frames = [predict[i] for i in range(len(predict))]
    n_alive = int(state.gauss_aux.alive.sum())
    bucket = scene.bucket_for(n_alive)
    it0 = VARIANT_ITERATION
    deg = scene.active_sh_degree(it0)
    weights = loss_weights(cfg, it0)
    weights['_in_densify_window'] = 1.0
    xyz_lr = scene.xyz_lr_fn(it0)
    step = make_train_step(scene)
    n_params = sum(p.numel() for p in state.conv_params.values())
    setup_s = time.perf_counter() - t0
    step_ms, metrics = [], []

    def run():
        nonlocal state
        for i in range(VARIANT_STEPS):
            t1 = time.perf_counter()
            state, m = step(state, cams[i % len(cams)], it0 + i, weights,
                            xyz_lr, active_sh_degree=deg, bucket=bucket)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1000.0)
            metrics.append({k: float(v) for k, v in m.items()})
        infer = InferenceScene(
            cfg, scene.metadata, scene.assets,
            AvatarState(state.gauss_params, state.gauss_aux,
                        scene.converter.state_dict()), device=DEVICE,
            iteration=it0 + VARIANT_STEPS)
        return infer, evaluate(infer, frames, n_frames=VARIANT_FRAMES,
                               keep_renders=True)

    torch.cuda.reset_peak_memory_stats()
    (infer, res), launches = driven(counters, run)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    later = sorted(step_ms[1:])
    log(f"variant {name} {' '.join(overrides)} ({gpu}): {n_alive} "
        f"Gaussians, {n_params} converter parameters, SH degree {deg}, "
        f"set-up {setup_s:.1f} s; {VARIANT_STEPS} steps from iteration "
        f"{it0}, median {later[len(later) // 2]:.3f} ms/step without the "
        f"first (first {step_ms[0]:.1f}), loss "
        f"{metrics[0]['loss/total_loss']:.5f} -> "
        f"{metrics[-1]['loss/total_loss']:.5f}; {VARIANT_FRAMES} frames, "
        f"mean {res['time_ms']:.3f} ms/frame without the first; peak "
        f"device memory {peak:.3f} GiB; launches {launches}")
    log(f"variant {name} last step: " + ", ".join(
        f"{k} {v:.6g}" for k, v in sorted(metrics[-1].items())
        if k.startswith('loss/')))
    for i, m in enumerate(metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            fail(f"variant {name} step {i}: non-finite {bad}")
        if m['overflow/pairs']:
            fail(f"variant {name} step {i}: pair_overflow "
                 f"{m['overflow/pairs']}")
    if any(res['pair_overflow']):
        fail(f"variant {name}: pair_overflow {res['pair_overflow']}")
    for i, (img, alpha) in enumerate(zip(res['images'], res['alphas'])):
        if not bool(img.isfinite().all()) \
                or not (0.0 <= float(img.min()) and float(img.max()) <= 1.0):
            fail(f"variant {name} frame {i}: image not finite in [0, 1]")
        if not float(alpha.mean()) > 0.0:
            fail(f"variant {name} frame {i}: no alpha coverage")
    want = {'composite_fwd': VARIANT_STEPS + VARIANT_FRAMES,
            'composite_bwd': VARIANT_STEPS,
            'segsum': k3_per_step(cfg) * VARIANT_STEPS, 'narrow_rows': 0,
            'conv_adam': (K5_PER_STEP if n_params else 0) * VARIANT_STEPS}
    if launches != want:
        fail(f"variant {name}: launches {launches}, expected {want}")

    cam = cams[0]
    with torch.no_grad():
        view = G.make_view(state.gauss_params, state.gauss_aux,
                           active_sh_degree=deg, max_sh_degree=3,
                           use_sh=scene.use_sh, bucket=bucket)
        conv_ms = profiled_device_ms(
            lambda: scene.converter(view, cam, it0), 5)
        extra = ''
        if name == 'v_distill':
            vox_ms = profiled_device_ms(scene.converter.rigid._voxel, 5)
            extra = f", the voxel's build {vox_ms:.3f} device ms"
    if name == 'v_smpl_nn':
        share, n_diff, gap, xyz, verts = nn_agreement(scene, state, cam,
                                                      bucket, it0)
        with torch.no_grad():
            nn_ms = profiled_device_ms(lambda: knn.nn_index(xyz, verts), 5)
        extra = (f", nn_index {nn_ms:.3f} device ms over {len(xyz)} "
                 f"queries and {len(verts)} vertices; indices equal to the "
                 f"CPU's: {share:.6f} ({n_diff} differ, the worst distance "
                 f"gap {gap:.3f} of the f32 rounding bound)")
        if gap > 1.0:
            fail(f"variant {name}: nearest vertices differ from the CPU's "
                 f"by more than a tie ({gap:.3f} of the bound)")
    log(f"variant {name} ({gpu}): the converter's forward "
        f"{conv_ms:.3f} device ms{extra}")
    del infer, scene, state
    train_reference(overrides, VARIANT_ITERATION,
                    f"variant {name} reference")


def variant_phase(counters, gpu):
    """Phase 12: every model variant of VARIANTS."""
    for name, overrides in VARIANTS.items():
        variant_run(name, list(overrides), counters, gpu)


# phase 13: the serving apps, from the last checkpoint phase 9 writes and an
# SMPL npz of the synthetic body, driven by a CLIFF-format motion made from SEED
SERVE_MOTION = 30        # frames of the motion npz
SERIES_FRAMES = 30       # render_series at 512^2
BODY_FRAMES = 10         # body_replace over the 1080^2 fixture frame
AR_FRAMES = 10           # the AR loop over the 1024^2 fixture frame
CAPTURE_FRAMES = 8       # capture_and_record at 512^2
CAPTURE_STEPS = 10       # training steps on the captured tree
SERVE_HW = 512
MIN_COVER = 0.01         # alpha > 0.5 on at least this share of each frame
# a decoded capture JPEG against the image written. A quality-95 4:2:0
# file (the bytes cv2 writes, tests/test_torch_jpeg.py) is off by more than
# 2 levels at sharp colour edges, so the share within 2 levels and the
# largest error are printed, not gated
JPEG_PSNR = 40.0
JPEG_LEVELS = 2
RENDER_MAX = 1.0 + 1e-5  # a render's colour: 1 plus the f32 rounding of
                         # its compositing sums


def motion_npz(path, n=SERVE_MOTION):
    """A CLIFF-format motion: n frames of small seeded body rotations, zero
    shape, a global_t 4 m in front of the camera and centred on the body,
    focal 1000."""
    import numpy as np
    rng = np.random.default_rng(SEED + 13)
    pose = (0.1 * rng.standard_normal((n, 72))).astype(np.float32)
    pose[:, :3] = 0.0
    global_t = (np.array([0.0, 0.2, 4.0])
                + 0.02 * rng.standard_normal((n, 3)))
    np.savez(path, pose=pose, shape=np.zeros((n, 10), np.float32),
             global_t=global_t.astype(np.float32), focal_l=np.float32(1000.0))
    return path


def board_feed(frame, n):
    """n (frame, board pose) pairs: small seeded rotations, the camera
    about 0.2 m (t_scale 4) behind the board."""
    import numpy as np
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(SEED + 14)
    return [(frame, (Rotation.from_rotvec(0.02 * rng.standard_normal(3))
                     .as_matrix(),
                     np.array([0.0, 0.0, 0.05])
                     + 0.01 * rng.standard_normal(3))) for _ in range(n)]


class ServeProbe:
    """Per-frame host times (synced) of one app run, by part: the pose
    (`parse` and `camera_pose_fields`: the LBS), `render_frame`, the
    resize and composite, and the PNG or JPEG write. A frame starts at the
    first parse of a new motion index. Keeps each render's checks and the
    arrays written as JPEG."""

    PARTS = ('pose', 'render', 'composite', 'write')

    def __init__(self):
        self.frames, self.renders, self.jpegs = [], [], []
        self.first = None
        self._depth = 0
        self._undo = []

    def _wrap(self, fn, part, on_done=None):
        def timed_part(*args, **kw):
            outer = self._depth == 0
            self._depth += 1
            try:
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                self._depth -= 1
            if outer:
                if part == 'pose' and (not self.frames
                                       or self.frames[-1]['idx'] != args[0]):
                    self.frames.append(dict({p: 0.0 for p in self.PARTS},
                                            idx=args[0], start=t0))
                self.frames[-1][part] += ms
                if on_done:
                    on_done(args, out)
            return out
        return timed_part

    def _set(self, obj, name, value):
        own = name in vars(obj)
        self._undo.append((obj, name, own, vars(obj).get(name)))
        setattr(obj, name, value)

    def install(self, scene, series):
        from gsavatar_torch import native
        from gsavatar_torch.apps import ar_render, body_replace
        from gsavatar_torch.utils import png

        def rendered(args, pkg):
            r, a = pkg.render, pkg.opacity_render
            if self.first is None:
                self.first = (r.clone(), a.clone())
            self.renders.append((bool(r.isfinite().all()), float(r.min()),
                                 float(r.max()),
                                 float((a > 0.5).float().mean())))
        self._set(series, 'parse', self._wrap(series.parse, 'pose'))
        self._set(series, 'camera_pose_fields',
                  self._wrap(series.camera_pose_fields, 'pose'))
        self._set(scene, 'render_frame',
                  self._wrap(scene.render_frame, 'render', rendered))
        comp = self._wrap(body_replace.composite_frame, 'composite')
        self._set(body_replace, 'composite_frame', comp)
        self._set(ar_render, 'composite_frame', comp)
        self._set(png, 'write_png', self._wrap(png.write_png, 'write'))
        self._set(native, 'write_jpeg', self._wrap(
            native.write_jpeg, 'write',
            lambda args, out: self.jpegs.append((args[0], args[1].copy()))))

    def remove(self, end):
        for obj, name, own, old in reversed(self._undo):
            if own:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._undo = []
        for f, nxt in zip(self.frames, self.frames[1:] + [{'start': end}]):
            f['total'] = (nxt['start'] - f['start']) * 1e3

    def summary(self):
        later = self.frames[1:]

        def med(k):
            v = sorted(f[k] for f in later)
            return v[len(v) // 2]
        return {k: med(k) for k in ('total',) + self.PARTS}


def run_app(label, fn, scene, series, counters, gpu, want_k1):
    """One app run under a ServeProbe with the launch counts set to 0 just
    before and read just after; checks K1's count, each render finite,
    in [0, RENDER_MAX] and covering MIN_COVER; prints the ms per frame and
    its split with the card's name and power limit."""
    probe = ServeProbe()
    probe.install(scene, series)
    try:
        out, launches = driven(counters, fn)
    finally:
        probe.remove(time.perf_counter())
    want = {'composite_fwd': want_k1, 'composite_bwd': 0, 'segsum': 0,
            'narrow_rows': 0, 'conv_adam': 0}
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want}")
    if len(probe.frames) != want_k1 or len(probe.renders) != want_k1:
        fail(f"{label}: {len(probe.frames)} frames, {len(probe.renders)} "
             f"renders")
    for i, (finite, lo, hi, cover) in enumerate(probe.renders):
        if not finite or lo < 0.0 or hi > RENDER_MAX:
            fail(f"{label} frame {i}: render finite {finite}, in "
                 f"[{lo}, {hi}]")
        if cover < MIN_COVER:
            fail(f"{label} frame {i}: alpha > 0.5 on {cover:.4f} of the "
                 f"pixels (the avatar is not in view)")
    s = probe.summary()
    covers = [r[3] for r in probe.renders]
    log(f"{label} ({gpu}): {want_k1} frames, {s['total']:.3f} ms/frame "
        f"(median without the first, host clock, synced; first "
        f"{probe.frames[0]['total']:.1f}): pose (LBS) {s['pose']:.3f}, "
        f"render_frame {s['render']:.3f}, resize+composite "
        f"{s['composite']:.3f}, write {s['write']:.3f} ms; alpha > 0.5 on "
        f"{min(covers):.4f}..{max(covers):.4f} of the pixels; launches "
        f"{launches}")
    return out, probe


def serving_phase(counters, ckpt, cfg, work, gpu):
    """Phase 13: the serving apps from phase 9's checkpoint `ckpt` (under
    its config `cfg`) and an SMPL npz of the synthetic body."""
    import numpy as np
    from gsavatar_torch import native
    from gsavatar_torch.apps import ar_render, body_replace
    from gsavatar_torch.apps.capture_and_record import capture_and_record
    from gsavatar_torch.apps.render_series import render_series
    from gsavatar_torch.camera.live import live_camera
    from gsavatar_torch.data import load_dataset
    from gsavatar_torch.data.image_ops import resize_linear
    from gsavatar_torch.inference import InferenceScene
    from gsavatar_torch.motion.series import MotionSeries
    from gsavatar_torch.utils import png

    body = load_dataset(cfg['dataset'], 'train')
    npz = os.path.join(work, 'smpl.npz')
    np.savez(npz, minimal_shape=body.metadata['minimal_shape'])
    motion = motion_npz(os.path.join(work, 'motion.npz'))
    t0 = time.perf_counter()
    serve = InferenceScene.from_smpl_npz(cfg, ckpt, npz, assets=body.assets,
                                         device=DEVICE)
    log(f"serving scene from {os.path.basename(ckpt)} and an SMPL npz: "
        f"{time.perf_counter() - t0:.2f} s, {int(serve.gauss_aux.alive.sum())}"
        f" Gaussians, raster {serve.raster_config.width}^2, iteration "
        f"{serve.iteration}, frame_dict rows {len(serve.metadata['frame_dict'])}")
    # the body at the origin for the orbit and the capture, 4 m in front of
    # the camera (the motion's global_t) for the video and the AR feed
    orbit = MotionSeries(motion, body.assets, trans=np.zeros(3, np.float32),
                         device=DEVICE)
    ahead = MotionSeries(motion, body.assets, device=DEVICE)

    # the npz route equals the checkpoint route, bit for bit
    ref = InferenceScene.from_checkpoint(cfg, ckpt, device=DEVICE)
    rots, Jtrs, bt = orbit.camera_pose_fields(0, serve.metadata)
    cam = live_camera(np.eye(3), [0.0, 0.0, 2.5], width=cfg['dataset'][
        'img_hw'][1], height=cfg['dataset']['img_hw'][0], rots=rots,
        Jtrs=Jtrs, bone_transforms=bt, device=DEVICE)
    # the checkpoint route renders at the checkpoint's iteration, the npz
    # route at the config's last; both here at the checkpoint's
    a = serve.render_frame(cam, ref.iteration)
    b = ref.render_frame(cam)
    same = torch.equal(a.render, b.render) and torch.equal(
        a.opacity_render, b.opacity_render)
    log(f"npz route against the checkpoint route at iteration "
        f"{ref.iteration}: equal bit for bit {same}, {a.n_pairs} pairs")
    if not same:
        fail("the npz route renders differently from the checkpoint route")

    # render_series: 30 frames at 512^2 under orbiting cameras
    serve512 = InferenceScene.from_smpl_npz(cfg, ckpt, npz,
                                            assets=body.assets,
                                            width=SERVE_HW, height=SERVE_HW,
                                            device=DEVICE)
    out_dir = os.path.join(work, 'series')
    frames, _ = run_app(
        'render_series', lambda: render_series(
            serve512, orbit, out_dir=out_dir, width=SERVE_HW,
            height=SERVE_HW, max_frames=SERIES_FRAMES, save_video=False),
        serve512, orbit, counters, gpu, SERIES_FRAMES)
    for i, img in enumerate(frames):
        if not np.array_equal(png.read_png(os.path.join(
                out_dir, f"{i:06d}.png")), img):
            fail(f"render_series: {i:06d}.png reads back different")

    # body_replace: 10 frames over the 1080^2 fixture frame
    with open(os.path.join(FIXTURES, 'digests.json')) as f:
        spec = json.load(f)
    video = native.read_jpeg(os.path.join(FIXTURES, spec['ps']['jpeg']))
    _, probe = run_app(
        'body_replace', lambda: body_replace.body_replace(
            serve, ahead, [video] * BODY_FRAMES,
            out_dir=os.path.join(work, 'body'), save_video=False),
        serve, ahead, counters, gpu, BODY_FRAMES)
    render, alpha = probe.first
    frame_t = torch.as_tensor(video, device=DEVICE)
    hw = video.shape[:2]
    for name, x in (('render', render.clamp(0, 1)), ('alpha', alpha)):
        if not torch.equal(resize_linear(x, hw).cpu(),
                           resize_linear(x.cpu(), hw)):
            fail(f"the float resize of the {name} differs from the CPU's")
    comp = body_replace.composite_frame(render, alpha, frame_t)
    if not torch.equal(comp.cpu(), body_replace.composite_frame(
            render.cpu(), alpha.cpu(), frame_t.cpu())):
        fail("the composite on the card differs from the CPU's")
    dev_ms = profiled_device_ms(
        lambda: body_replace.composite_frame(render, alpha, frame_t), 5)
    log(f"body_replace ({gpu}): resize {render.shape[0]}^2 -> {hw[0]}^2 and "
        f"composite {dev_ms:.3f} device ms/frame; the float resize and the "
        f"composite equal the CPU's bit for bit")
    cpu_scene = InferenceScene.from_smpl_npz(cfg, ckpt, npz,
                                             assets=body.assets, device='cpu')
    rots, Jtrs, bt = ahead.camera_pose_fields(0, serve.metadata)
    K = body_replace.series_K(ahead, hw[1], hw[0])
    rc = serve.raster_config
    want = cpu_scene.render_frame(live_camera(
        np.eye(3, dtype=np.float32), np.zeros(3, np.float32), K=K,
        width=rc.width, height=rc.height, rots=rots, Jtrs=Jtrs,
        bone_transforms=bt, device='cpu'))
    render_gates(render.clamp(0, 1), want.render.clamp(0, 1),
                 'body_replace frame 0 (CPU path)')
    render_gates(alpha, want.opacity_render, 'body_replace alpha 0 (CPU path)')

    # the AR loop: 10 seeded board poses over the 1024^2 fixture frame
    webcam = native.read_jpeg(os.path.join(FIXTURES, spec['zju']['jpeg']))
    K = body_replace.series_K(ahead, webcam.shape[1], webcam.shape[0])
    shown, _ = run_app(
        'ar_loop', lambda: list(ar_render.ar_loop(
            serve, ahead, board_feed(webcam, AR_FRAMES), K,
            max_frames=AR_FRAMES, display=False)),
        serve, ahead, counters, gpu, AR_FRAMES)
    if len(shown) != AR_FRAMES or shown[0].shape != webcam.shape:
        fail(f"ar_loop: {len(shown)} composites")

    # capture_and_record into a ZJU-MoCap tree, then 10 training steps on
    # it. The ZJU-MoCap loader's body is the 6890-vertex template
    # (find_assets), so the capture's scene takes the template's metadata
    # (no npz) to write that body's minimal_shape.
    tree = os.path.join(work, 'capture')
    capture_scene = InferenceScene.from_smpl_npz(
        cfg, ckpt, width=SERVE_HW, height=SERVE_HW, device=DEVICE)
    template = MotionSeries(motion, capture_scene.assets,
                            trans=np.zeros(3, np.float32), device=DEVICE)
    _, probe = run_app(
        'capture_and_record', lambda: capture_and_record(
            capture_scene, template, out_dir=os.path.join(tree, 'S1'),
            width=SERVE_HW, height=SERVE_HW, max_frames=CAPTURE_FRAMES),
        capture_scene, template, counters, gpu, CAPTURE_FRAMES)
    worst, near, psnrs = 0, 1.0, []
    for path, img in probe.jpegs:
        err = np.abs(native.read_jpeg(path).astype(np.int64) - img)
        psnr = 10 * math.log10(255.0 ** 2 / max(float((err ** 2).mean()),
                                                1e-12))
        worst, psnrs = max(worst, int(err.max())), psnrs + [psnr]
        near = min(near, float((err <= JPEG_LEVELS).mean()))
        if psnr < JPEG_PSNR:
            fail(f"{path}: PSNR {psnr:.2f} dB against the image written")
    log(f"capture JPEGs: {len(probe.jpegs)} decode back at PSNR "
        f"{min(psnrs):.2f}..{max(psnrs):.2f} dB, at least {near:.5f} of "
        f"the values within {JPEG_LEVELS} levels, largest error {worst} "
        f"levels")
    cfg_z, scene_z, cams = real_scene([
        'dataset=zjumocap_377_mono', f'dataset.root_dir={tree}',
        'dataset.subject=S1', "dataset.train_views=['1']",
        "dataset.val_views=['1']", f'dataset.train_frames=[0,'
        f'{CAPTURE_FRAMES},1]', f'dataset.test_frames.view=[0,'
        f'{CAPTURE_FRAMES},1]', 'dataset.n_points=50000'],
        'captured ZJU-MoCap tree', gpu)
    if len(cams) != CAPTURE_FRAMES:
        fail(f"the captured tree loads {len(cams)} frames")
    real_train(scene_z, cams, CAPTURE_STEPS, counters, 'captured tree', gpu)


# phase 14: multi-subject training (BASELINE config 5's four subjects; here
# four synthetic subjects that differ by dataset.seed) and B frames per
# optimizer step, at the bench shape: 20 iterations, a densify at 10, the
# opacity reset at 15, validation at 20 on 1 frame a split, the final
# checkpoints at 20
MS_SEEDS = (0, 1, 2, 3)
MS_ALONE = (0, 3)         # the subjects run again alone
P14_ITERATIONS = 20
P14_OVERRIDES = (
    f"opt.iterations={P14_ITERATIONS}", "model.gaussian.delay=0",
    "opt.densify_from_iter=5", "opt.densification_interval=10",
    f"opt.densify_until_iter={P14_ITERATIONS}",
    "opt.opacity_reset_interval=15", "test_interval=20", "max_val_frames=1",
    "strict_overflow=true")
BATCH_FRAMES = 2
BATCH = ("parallel.data=1", "parallel.model=1")
B1_ITERATIONS = 5


class StepTimes:
    """While installed, each step that `module.<name>` (a step factory)
    makes is timed on the host clock, ended by a device sync."""

    def __init__(self, module, name):
        self.module, self.name, self.ms = module, name, []

    def __enter__(self):
        self.make = make = getattr(self.module, self.name)
        times = self.ms

        def timed_make(*args, **kwargs):
            step = make(*args, **kwargs)

            def timed(*a, **k):
                t0 = time.perf_counter()
                out = step(*a, **k)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1000.0)
                return out
            return timed
        setattr(self.module, self.name, timed_make)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.make)

    def median(self) -> float:
        return later_median(self.ms)

    def per_iteration(self, n: int) -> list:
        """The times summed over each run of `n` steps: an iteration's,
        where a driver makes `n` steps an iteration (one a subject)."""
        return [sum(self.ms[k:k + n]) for k in range(0, len(self.ms), n)]


def later_median(ms: list) -> float:
    """The median of the step times after the first."""
    later = sorted(ms[1:])
    return later[len(later) // 2]


def rows(logger, key):
    return rows_of(logger.history, key)


def p14_cfg(work, tag, extra=()):
    from gsavatar_torch.config import BENCH_OVERRIDES, load_config
    return load_config(list(BENCH_OVERRIDES) + list(P14_OVERRIDES)
                       + list(extra) + [f"exp_dir={os.path.join(work, tag)}"])


def p14_launches(iterations, val_frames, label, launches, updates):
    """`iterations` frames trained, `val_frames` rendered and `updates`
    optimizer steps."""
    want = {'composite_fwd': iterations + val_frames,
            'composite_bwd': iterations,
            'segsum': K3_PER_STEP * iterations, 'narrow_rows': 0,
            'conv_adam': K5_PER_STEP * updates}
    log(f"{label} launches {launches} (expected {want})")
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want}")


def memory_of(counters, fn):
    """`driven(counters, fn)` with the device memory (GiB) allocated just
    before it, after the tensors nothing refers to are freed, and the peak
    while it ran: (result, launches, (before, peak))."""
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    out, launches = driven(counters, fn)
    return out, launches, (before, torch.cuda.max_memory_allocated() / 2 ** 30)


def gib(mem) -> str:
    before, peak = mem
    return f"{peak:.3f} GiB ({before:.3f} held before the run)"


def single_run(work, tag, extra, counters=None, max_iterations=None):
    """`train.training` on a prerendered scene of the phase-14 config with
    `extra`; returns (state, logger, step times, memory, launches)."""
    from gsavatar_torch import train
    from gsavatar_torch.parallel import shard
    cfg = p14_cfg(work, tag, extra)
    scene = driver_scene(cfg)
    with StepTimes(train, 'make_train_step') as t1, \
            StepTimes(shard, 'make_batch_train_step') as tb:
        (_, state, logger), launches, mem = memory_of(
            counters or {}, lambda: train.training(
                cfg, scene=scene, log_every=1, progress=False,
                max_iterations=max_iterations))
    check_finite_records(logger, tag)
    return state, logger, (tb if tb.ms else t1), mem, launches


def multi_subject_phase(counters, work, gpu):
    """Phase 14: S = 4 subjects at the bench shape against subjects 0 and 3
    alone; B = 2 frames per step; the B = 1 route against the plain route;
    a small B = 2 step on the card against the CPU."""
    from gsavatar_torch import train
    from gsavatar_torch.parallel import multi_subject as msm
    S = len(MS_SEEDS)
    cfg = p14_cfg(work, 'ms', [
        f"parallel.subjects={[{'seed': i} for i in MS_SEEDS]}"])
    t0 = time.perf_counter()
    ms = msm.MultiSubjectScene(cfg, seed=SEED, device=DEVICE)
    for scene in ms.scenes:
        prerendered(scene)
    log(f"multi-subject set-up: {S} subjects, "
        f"{time.perf_counter() - t0:.1f} s")
    with StepTimes(train, 'make_train_step') as t_ms:
        (_, states, logger), launches, ms_mem = memory_of(
            counters, lambda: msm.training_multi_subject(
                cfg, ms=ms, log_every=1, progress=False))
    del ms
    check_finite_records(logger, 'multi-subject run')
    # S steps an iteration; each subject's validation renders 1 test frame
    # and 1 training frame
    p14_launches(S * P14_ITERATIONS, 2 * S, 'multi-subject run', launches,
                 S * P14_ITERATIONS)
    densify = {k: v for r in logger.history for k, v in r.items()
               if k.startswith('densify/')}
    if list(rows(logger, 'densify/n_alive')) != [10] or not any(
            c + s for c, s in zip(densify['densify/n_cloned'],
                                  densify['densify/n_split'])):
        fail(f"multi-subject densify: {densify}")
    log("multi-subject densify at 10, per subject: " + "; ".join(
        f"subject {i}: " + ", ".join(
            f"{k.split('/')[1]} {v[i]}" for k, v in densify.items())
        for i in range(S)))
    for i in range(S):
        ckpt = os.path.join(work, 'ms', f'subject{i}',
                            f'ckpt{P14_ITERATIONS}.pt')
        if not os.path.exists(ckpt):
            fail(f"no checkpoint {ckpt}")
    val = {k: v for r in logger.history for k, v in r.items()
           if k.endswith('/val/test_psnr')}
    log(f"multi-subject validation at 20: test PSNR {val}")
    xyz = {i: states[i].gauss_params.xyz for i in MS_ALONE}
    del states

    alone = {}
    for i in MS_ALONE:
        state, slog, t1, mem, _ = single_run(
            work, f'alone{i}', [f"dataset.seed={MS_SEEDS[i]}",
                                f"seed={SEED + i}"])
        alone[i] = (t1.median(), mem)
        for key in ('loss/total_loss', 'n_alive'):
            got, want = rows(logger, f'subject{i}/{key}'), rows(slog, key)
            if got != want:
                bad = [s for s in want if got.get(s) != want[s]]
                fail(f"subject {i} differs from its single run in {key} "
                     f"from iteration {bad[0]}: {got.get(bad[0])} against "
                     f"{want[bad[0]]}")
        if densify['densify/n_alive'][i] != rows(slog, 'densify/n_alive')[10]:
            fail(f"subject {i}: densify n_alive differs from its single run")
        if not torch.equal(xyz[i], state.gauss_params.xyz):
            fail(f"subject {i}: final xyz differs from its single run")
        log(f"subject {i} equals its single run bit for bit: "
            f"{P14_ITERATIONS} losses, n_alive, final xyz "
            f"({int(state.gauss_aux.alive.sum())} alive)")
        del state
    one, one_mem = alone[MS_ALONE[0]]
    ms_median = later_median(t_ms.per_iteration(S))
    log(f"multi-subject S={S} ({gpu}): median {ms_median:.3f} ms per "
        f"iteration (iterations 2-{P14_ITERATIONS}, host clock, synced), "
        f"one subject alone " + ", ".join(
            f"{t:.3f} ms (subject {i})" for i, (t, _) in alone.items())
        + f"; ratio {ms_median / one:.2f}; peak device memory "
        f"{gib(ms_mem)}, one subject alone " + ", ".join(
            gib(m) for _, m in alone.values()))

    # B = 2 frames per step, 20 iterations
    _, blog, tb, b_mem, launches = single_run(
        work, 'b2', BATCH + (f"parallel.frames_per_step={BATCH_FRAMES}",),
        counters)
    p14_launches(BATCH_FRAMES * P14_ITERATIONS, 2,
                 f'B={BATCH_FRAMES} run', launches, P14_ITERATIONS)
    if list(rows(blog, 'densify/n_alive')) != [10]:
        fail(f"B={BATCH_FRAMES} run: densify at "
             f"{list(rows(blog, 'densify/n_alive'))}")
    log(f"B={BATCH_FRAMES} run: loss {rows(blog, 'loss')[1]:.5f} -> "
        f"{rows(blog, 'loss')[P14_ITERATIONS]:.5f}, densify "
        f"n_alive {rows(blog, 'densify/n_alive')[10]}")

    # the B = 1 route against the plain route, 5 iterations
    (s0, l0, t_plain, _, _), (s1, l1, t_b1, _, _) = (
        single_run(work, tag, extra, max_iterations=B1_ITERATIONS)
        for tag, extra in (('plain', ()), ('b1', BATCH)))
    a, b = _state_tensors(s0), _state_tensors(s1)
    bad = [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]
    if rows(l0, 'loss/total_loss') != rows(l1, 'loss/total_loss') or bad:
        fail(f"the B=1 route differs from the plain route: {bad[:5]}")
    log(f"B=1 route equals the plain route bit for bit: {B1_ITERATIONS} "
        f"losses, {len(a)} state tensors")
    log(f"frames_per_step B={BATCH_FRAMES} ({gpu}): median "
        f"{tb.median():.3f} ms per step (steps 2-{P14_ITERATIONS}, host "
        f"clock, synced), B=1 {one:.3f} ms (subject 0 alone, the same "
        f"config; the B=1 route {t_b1.median():.3f} and the plain route "
        f"{t_plain.median():.3f} over steps 2-{B1_ITERATIONS}); ratio "
        f"{tb.median() / one:.2f}; peak device memory {gib(b_mem)}, B=1 "
        f"{gib(one_mem)}")

    train_reference(label=f'B={BATCH_FRAMES} train reference',
                    frames=BATCH_FRAMES)


# phase 15: the ('data', 'model') mesh over torch.distributed at the bench
# shape and phase 14's config: K1 and K2 by tile range, the mesh route at
# world size 1 over NCCL, two ranks that share the card over gloo, and two
# NCCL ranks on separate cards where the machine has them; 5 iterations a
# route (no densify: phase 14's first is at 10)
MESH_SPLITS = (2, 4)
P15_ITERATIONS = 5
P15_B2 = BATCH + (f"parallel.frames_per_step={BATCH_FRAMES}",)
P15_ROUTES = {
    'data2': ("parallel.data=2", "parallel.model=1",
              f"parallel.frames_per_step={BATCH_FRAMES}"),
    'model2': ("parallel.data=1", "parallel.model=2",
               f"parallel.frames_per_step={BATCH_FRAMES}"),
}
# each rank's frames a step, by route: the data axis splits the batch, the
# model axis renders every frame on each rank over half the tiles
P15_FRAMES = {'data2': 1, 'model2': BATCH_FRAMES, 'subjects': 2}
# each rank's optimizer steps an iteration: one on either route, one per
# subject it holds
P15_UPDATES = {'data2': 1, 'model2': 1, 'subjects': 2}
P15_SUBJECTS = (f"parallel.subjects={[{'seed': i} for i in MS_SEEDS]}",
                "parallel.data=2")
# a route over ranks against one device's B-frame route: the first step's
# loss terms bit for bit (the same state and draws, no sum over ranks yet),
# the later steps' within bench.py's LOSS_RTOL, and each float state tensor
# at bench.py's gate (GRAD_COS, GRAD_REL), integers exactly. The ranks'
# gradients are added in another order than autograd adds the frames',
# and Adam steps by its learning rate in the direction of a gradient that
# is rounding noise (the isotropic initial Gaussians' rotations): the CPU
# tests' gates (tests/test_torch_distributed.py: loss terms 1e-6, each
# tensor's mean difference 1e-5 of its largest value) held over their 3
# steps at 64^2, but at the bench shape on the card the AIAP loss moved
# 2.3e-6 by the fifth step and the rotations' mean 2.4e-5
P15_TIMEOUT = 600


def spawn_ranks(fn, n: int, args, timeout: float):
    """`fn(rank, *args)` on n processes (`torch.multiprocessing.spawn`);
    fails, and ends them all, if any fails or they outlast `timeout`."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(fn, args=args, nprocs=n, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            fail(f"{fn.__name__} on {n} ranks did not finish in {timeout} s")


def tile_range_phase(frame_pairs, k2_args, gpu):
    """Phase 15, 1: K1 on the bench frame's pairs and K2 on the bench
    step's inputs, each over the M = 2 and 4 tile ranges of the model
    ranks: each range against its plain version, the ranges put together
    against the whole launch bit for bit, and each range's device ms."""
    from gsavatar_torch.ops.rasterizer import composite as K
    pd1, ts1 = frame_pairs
    pd, ts, ct, fwd, grid_x = k2_args
    num_tiles = ts.shape[0] - 1
    k1_whole = K.composite_pairs_fwd(pd1, ts1, grid_x)
    k2_whole = K.composite_pairs_bwd(pd, ts, ct, fwd, grid_x)
    k1_ms = timed(lambda: K.composite_pairs_fwd(pd1, ts1, grid_x), 100)
    k2_ms = timed(lambda: K.composite_pairs_bwd(pd, ts, ct, fwd, grid_x), 100)
    full1, full2 = int(torch.diff(ts1).argmax()), int(torch.diff(ts).argmax())
    for M in MESH_SPLITS:
        if num_tiles % M:
            fail(f"{num_tiles} tiles do not split over {M} model ranks")
        per = num_tiles // M
        outs, total = [], torch.zeros_like(k2_whole)
        ms1, ms2, err1, err2 = [], [], 0.0, 0.0
        for m in range(M):
            base = m * per
            r1, r2 = ts1[base:base + per + 1], ts[base:base + per + 1]
            ct_r = ct[base:base + per].contiguous()
            fwd_r = fwd[base:base + per]
            got = K.composite_pairs_fwd(pd1, r1, grid_x, base)
            want = K.composite_pairs_fwd_plain(pd1, r1, grid_x, base)
            g = K.composite_pairs_bwd(pd, r2, ct_r, fwd_r, grid_x, base)
            g_want = K.composite_pairs_bwd_plain(pd, r2, ct_r, fwd_r, grid_x,
                                                 base)
            scale = K.composite_pairs_bwd_scale(pd, r2, ct_r, fwd_r, grid_x,
                                                base)
            torch.cuda.synchronize()
            e1 = float((got - want).abs().max())
            if not e1 <= K1_TOL or not torch.equal(got[:, 3:5], want[:, 3:5]):
                fail(f"K1 on tiles {base}..{base + per - 1} disagrees with "
                     f"its plain version: {e1}")
            n_off = int(((g - g_want).abs() > K2_TOL * scale).sum())
            lo, hi = int(r2[0]), int(r2[-1])
            if n_off or g[:lo].any() or g[hi:].any():
                fail(f"K2 on tiles {base}..{base + per - 1}: {n_off} values "
                     f"off its plain version, or rows outside [{lo}, {hi}) "
                     f"not zero")
            err1, err2 = max(err1, e1), max(err2, float(
                (g - g_want).abs().max()))
            outs.append(got)
            total += g
            ms1.append(timed(lambda: K.composite_pairs_fwd(
                pd1, r1, grid_x, base), 100))
            ms2.append(timed(lambda: K.composite_pairs_bwd(
                pd, r2, ct_r, fwd_r, grid_x, base), 100))
        if not torch.equal(torch.cat(outs), k1_whole):
            fail(f"K1's {M} ranges put together differ from the whole launch")
        if not torch.equal(total, k2_whole):
            fail(f"K2's {M} ranges added differ from the whole launch")
        for name, ms, whole, full, err in (('K1', ms1, k1_ms, full1, err1),
                                           ('K2', ms2, k2_ms, full2, err2)):
            slow = max(range(M), key=lambda m: ms[m])
            log(f"{name} by tile range, M={M} ({gpu}): ranges "
                + ", ".join(f"{t:.4f}" for t in ms)
                + f" ms, sum {sum(ms):.4f}, slowest {ms[slow]:.4f} (range "
                f"{slow}; the fullest tile {full} is in range {full // per}) "
                f"against the whole launch's {whole:.4f} ms: "
                f"{ms[slow] / whole:.3f} of it; each range within its "
                f"tolerance of its plain version (max abs err {err:.3e}), "
                f"the ranges put together equal the whole launch bit for bit")


def nccl_world_one(counters, work, gpu):
    """Phase 15, 2: `{data: 1, model: 1}` at B = 2 with a process group of
    world size 1 over NCCL against the same run without one (the B-frame
    route of phase 14), bit for bit. Returns the latter's (state, logger,
    step times): the one-device reference of the routes over ranks."""
    import torch.distributed as dist
    from gsavatar_torch.parallel import mesh as mesh_mod
    s0, l0, t0, _, n0 = single_run(work, 'p15_one', P15_B2, counters,
                                   max_iterations=P15_ITERATIONS)
    mesh_mod.initialize_distributed(
        f'tcp://127.0.0.1:{mesh_mod.free_port()}', 1, 0)
    try:
        backend = dist.get_backend()
        s1, l1, t1, _, n1 = single_run(work, 'p15_nccl1', P15_B2, counters,
                                       max_iterations=P15_ITERATIONS)
    finally:
        dist.destroy_process_group()
    if backend != 'nccl':
        fail(f"the world-size-1 group runs {backend}, not NCCL")
    for label, n in (('B=2 route', n0), ('world-1 NCCL route', n1)):
        p14_launches(BATCH_FRAMES * P15_ITERATIONS, 0, label, n,
                     P15_ITERATIONS)
    a, b = _state_tensors(s0), _state_tensors(s1)
    bad = [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]
    if rows(l0, 'loss/total_loss') != rows(l1, 'loss/total_loss') or bad:
        fail(f"the world-1 NCCL route differs from the B=2 route: {bad[:5]}")
    log(f"mesh route at world size 1 over NCCL ({gpu}): median "
        f"{t1.median():.3f} ms per step (steps 2-{P15_ITERATIONS}, host "
        f"clock, synced) against {t0.median():.3f} without a process group; "
        f"bit-equal: {P15_ITERATIONS} losses, {len(a)} state tensors")
    del s1
    return s0, l0, t0


class RankSteps:
    """While installed, each step that `shard.make_sharded_train_step`
    makes is timed on the host clock (ended by a device sync), and then
    every tensor of the state, the generator's state and the step counts
    are broadcast from rank 0 and compared with this rank's, bit for
    bit."""

    def __enter__(self):
        from gsavatar_torch.parallel import shard
        self.shard, self.make = shard, shard.make_sharded_train_step
        self.ms, self.checked = [], 0
        probe = self

        def make(scene, mesh):
            step = probe.make(scene, mesh)

            def run(state, *a, **k):
                t0 = time.perf_counter()
                out = step(state, *a, **k)
                torch.cuda.synchronize()
                probe.ms.append((time.perf_counter() - t0) * 1000.0)
                for name, x in _state_tensors(out[0]).items():
                    if not torch.equal(mesh.broadcast(x.clone(), 0), x):
                        fail(f"rank {mesh.rank} differs from rank 0 in "
                             f"{name} after step {len(probe.ms)}")
                probe.checked += 1
                return out
            return run
        shard.make_sharded_train_step = make
        return self

    def __exit__(self, *exc):
        self.shard.make_sharded_train_step = self.make

    def median(self) -> float:
        return later_median(self.ms)


def kernel_counters():
    """Each kernel's wrapper by name: its `launches` count the launches."""
    from gsavatar_torch.ops import conv_adam, segsum_blocked
    from gsavatar_torch.ops.rasterizer import composite
    from gsavatar_torch.tools import profile_narrow_dma
    return {'composite_fwd': composite.composite_pairs_fwd,
            'composite_bwd': composite.composite_pairs_bwd,
            'segsum': segsum_blocked.segment_sum_sorted_blocked,
            'narrow_rows': profile_narrow_dma.run,
            'conv_adam': conv_adam.conv_adam_step}


def p15_rank(rank, port, work):
    """Phase 15, 3: rank `rank` of two that share the card over gloo: the
    two single-subject routes (every state compared with rank 0's after
    every step) and four subjects over the two data ranks. Saves each
    route's step times, launches and logged rows, rank 0's final states
    and the states of subjects 0 and 3, under `work`."""
    import torch.distributed as dist
    from gsavatar_torch import train
    from gsavatar_torch.parallel import mesh as mesh_mod
    from gsavatar_torch.parallel import multi_subject as msm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_mod.initialize_distributed(f'tcp://127.0.0.1:{port}', 2, rank,
                                    backend='gloo')
    counters = kernel_counters()
    out = {}
    try:
        for tag, extra in P15_ROUTES.items():
            cfg = p14_cfg(work, f'p15_{tag}', extra)
            scene = driver_scene(cfg)
            with RankSteps() as steps:
                (_, state, logger), launches = driven(
                    counters, lambda: train.training(
                        cfg, scene=scene, log_every=1, progress=False,
                        max_iterations=P15_ITERATIONS))
            out[tag] = {'ms': steps.ms, 'checked': steps.checked,
                        'launches': launches,
                        'rows': logger.history if logger else None}
            if rank == 0:
                torch.save({k: v.cpu() for k, v in
                            _state_tensors(state).items()},
                           os.path.join(work, f'p15_{tag}.pt'))
            del scene, state
        cfg = p14_cfg(work, 'p15_subjects', P15_SUBJECTS)
        mine = range(2 * rank, 2 * rank + 2)
        ms = msm.MultiSubjectScene(cfg, seed=SEED, device=DEVICE,
                                   subjects=mine)
        for scene in ms.scenes:
            prerendered(scene)
        with StepTimes(train, 'make_train_step') as t_ms:
            (_, states, _), launches = driven(
                counters, lambda: msm.training_multi_subject(
                    cfg, ms=ms, log_every=1, progress=False,
                    max_iterations=P15_ITERATIONS))
        out['subjects'] = {'ms': t_ms.per_iteration(len(mine)),
                           'launches': launches}
        for i, state in zip(mine, states):
            if i in MS_ALONE:
                torch.save({k: v.cpu() for k, v in
                            _state_tensors(state).items()},
                           os.path.join(work, f'p15_subject{i}.pt'))
        torch.save(out, os.path.join(work, f'p15_rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def p15_nccl_rank(rank, port, work):
    """Phase 15, 4: rank `rank` of two NCCL ranks, each on its own card:
    the data route's 5 steps; saves its step times."""
    global DEVICE
    import torch.distributed as dist
    from gsavatar_torch import train
    from gsavatar_torch.parallel import mesh as mesh_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE='2')
    mesh_mod.initialize_distributed(f'tcp://127.0.0.1:{port}', 2, rank)
    DEVICE = f'cuda:{rank}'
    try:
        cfg = p14_cfg(work, f'p15_nccl{rank}', P15_ROUTES['data2'])
        scene = driver_scene(cfg)
        with RankSteps() as steps:
            train.training(cfg, scene=scene, log_every=1, progress=False,
                           max_iterations=P15_ITERATIONS)
        torch.save({'backend': dist.get_backend(), 'ms': steps.ms},
                   os.path.join(work, f'p15_nccl_rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def state_within(got, want, label):
    """A route over ranks against one device's: integer tensors exactly,
    each float tensor with a cosine > GRAD_COS and a mean difference below
    GRAD_REL of its largest |value|. Returns (bit-equal tensors, the worst
    mean and largest differences over the largest |value|, the lowest
    cosine)."""
    same, worst_mean, worst_max, low_cos = 0, (0.0, ''), (0.0, ''), 1.0
    for k, v in want.items():
        g, v = got[k].cpu(), v.cpu()
        if torch.equal(g, v):
            same += 1
            continue
        if not v.dtype.is_floating_point:
            fail(f"{label}: {k} differs")
        g, v = g.double().flatten(), v.double().flatten()
        scale = max(float(v.abs().max()), 1e-30)
        d = (g - v).abs()
        mean, big = float(d.mean()) / scale, float(d.max()) / scale
        cos = float(g @ v / max(float(g.norm() * v.norm()), 1e-300))
        if not (cos > GRAD_COS and mean < GRAD_REL):
            fail(f"{label}: {k} cosine {cos:.7f}, mean difference "
                 f"{mean:.3e} of its largest value (gates > {GRAD_COS}, "
                 f"< {GRAD_REL:g})")
        worst_mean = max(worst_mean, (mean, k))
        worst_max = max(worst_max, (big, k))
        low_cos = min(low_cos, cos)
    return same, worst_mean, worst_max, low_cos


def mesh_phase(counters, work, gpu, frame_pairs, k2_args):
    """Phase 15: the mesh, at the bench shape."""
    from gsavatar_torch.parallel import mesh as mesh_mod
    t_phase = time.perf_counter()
    tile_range_phase(frame_pairs, k2_args, gpu)
    s_ref, l_ref, t_ref = nccl_world_one(counters, work, gpu)
    want_state = {k: v.cpu() for k, v in _state_tensors(s_ref).items()}
    del s_ref

    t0 = time.perf_counter()
    spawn_ranks(p15_rank, 2, (mesh_mod.free_port(), work), P15_TIMEOUT)
    log(f"two gloo ranks on one card: {time.perf_counter() - t0:.1f} s "
        f"with their start and set-up")
    ranks = [torch.load(os.path.join(work, f'p15_rank{r}.pt'))
             for r in range(2)]
    loss_keys = [k for k in next(r for r in l_ref.history if 'loss' in r)
                 if k.startswith('loss')]
    for tag in P15_ROUTES:
        for r, res in enumerate(ranks):
            p14_launches(P15_FRAMES[tag] * P15_ITERATIONS, 0,
                         f"{tag} rank {r}", res[tag]['launches'],
                         P15_UPDATES[tag] * P15_ITERATIONS)
            if res[tag]['checked'] != P15_ITERATIONS:
                fail(f"{tag} rank {r}: {res[tag]['checked']} steps checked")
        worst_loss = (0.0, '')
        for key in loss_keys:
            got, want = rows_of(ranks[0][tag]['rows'], key), rows(l_ref, key)
            if got[1] != want[1]:
                fail(f"{tag}: {key} at step 1: {got[1]!r} against one "
                     f"device's {want[1]!r}")
            for step in want:
                rel = abs(got[step] - want[step]) / max(abs(want[step]),
                                                        1e-30)
                if not rel <= LOSS_RTOL:
                    fail(f"{tag}: {key} at step {step}: {got[step]!r} "
                         f"against one device's {want[step]!r}")
                worst_loss = max(worst_loss, (rel, f"{key} at step {step}"))
        same, mean, big, cos = state_within(
            torch.load(os.path.join(work, f'p15_{tag}.pt')), want_state, tag)
        log(f"{tag} on two gloo ranks sharing the card ({gpu}): median "
            + ", ".join(f"{later_median(res[tag]['ms']):.3f}"
                        for res in ranks)
            + f" ms per step on ranks 0, 1 (steps 2-{P15_ITERATIONS}, host "
            f"clock, synced) against one device's {t_ref.median():.3f}; "
            f"both ranks' states bit-equal after every step; against one "
            f"device: step 1's loss terms bit-equal, the worst later "
            f"{worst_loss[0]:.3e} relative ({worst_loss[1] or '-'}), "
            f"{same} of "
            f"{len(want_state)} state tensors bit-equal, the worst mean "
            f"difference {mean[0]:.3e} ({mean[1] or '-'}) and the worst "
            f"element {big[0]:.3e} ({big[1] or '-'}) of the largest value, "
            f"the lowest cosine {cos:.7f}; "
            f"launches per rank {ranks[0][tag]['launches']}")
    for r, res in enumerate(ranks):
        p14_launches(P15_FRAMES['subjects'] * P15_ITERATIONS, 0,
                     f"subjects rank {r}", res['subjects']['launches'],
                     P15_UPDATES['subjects'] * P15_ITERATIONS)
    for i in MS_ALONE:
        state, _, t1, _, _ = single_run(
            work, f'p15_alone{i}', [f"dataset.seed={MS_SEEDS[i]}",
                                    f"seed={SEED + i}"],
            max_iterations=P15_ITERATIONS)
        got = torch.load(os.path.join(work, f'p15_subject{i}.pt'))
        want = _state_tensors(state)
        bad = [k for k in want if not torch.equal(got[k], want[k].cpu())]
        if bad:
            fail(f"subject {i} on its data rank differs from its run alone: "
                 f"{bad[:5]}")
        del state
    log(f"four subjects on two gloo data ranks ({gpu}): median "
        + ", ".join(f"{later_median(res['subjects']['ms']):.3f}"
                    for res in ranks)
        + f" ms per iteration of two subjects on ranks 0, 1; subjects "
        f"{', '.join(map(str, MS_ALONE))} bit-equal to their runs alone "
        f"({P15_ITERATIONS} iterations, every state tensor)")

    n_gpus = torch.cuda.device_count()
    if n_gpus >= 2:
        spawn_ranks(p15_nccl_rank, 2, (mesh_mod.free_port(), work),
                    P15_TIMEOUT)
        res = [torch.load(os.path.join(work, f'p15_nccl_rank{r}.pt'))
               for r in range(2)]
        log(f"data2 on two NCCL ranks on separate cards ({gpu}): backend "
            f"{res[0]['backend']}, median "
            + ", ".join(f"{later_median(r['ms']):.3f}" for r in res)
            + " ms per step on ranks 0, 1; both ranks' states bit-equal "
            "after every step")
    else:
        log(f"two NCCL ranks on separate cards did not run: this machine "
            f"has {n_gpus} GPU, and NCCL takes one rank per GPU; that route "
            f"is untested here")
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")


def rows_of(history, key):
    return {r['step']: r[key] for r in history if key in r}


# phase 16: the custom-video tooling. A 12-frame video at the custom
# dataset's raw size (`data/mydataset.MyDataset.RAW_HW`) and its
# segmentation's mask stack at half that size go through steps 2-6 of
# `tooling.build_dataset` into a ZJU-format tree, which the port preloads
# and trains on. The card's machine has no OpenCV, so `StandInVideo` stands
# in for `motion/streams.VideoStream`; the committed digests
# (tests/fixtures/torch_tooling, written on the CPU and held there to
# OpenCV's and the JAX package's output) say what the tree must hold.
TOOL_FRAMES = 12
TOOL_RAW = (1080, 1920)
TOOL_MASK = (540, 960)
TOOL_STEPS = 10
TOOL_VAL = (5, 10)
TOOL_VAL_FRAMES = 2      # per split and validation
TOOL_TRACE = (3, 6)      # the profiler's window of iterations
TOOL_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'tests', 'fixtures', 'torch_tooling')
# the kernels' names in a trace
TRACE_NAMES = {'composite_fwd': 'composite_fwd_kernel',
               'composite_bwd': 'composite_bwd_kernel',
               'segsum': 'segsum_chunks'}


def tooling_frame(i: int):
    """Video frame i: (1080, 1920, 3) uint8 RGB, smooth seeded content."""
    import numpy as np
    h, w = TOOL_RAW
    rng = np.random.default_rng(SEED + 100 + i)
    y, x = np.mgrid[0:h, 0:w] / h
    img = np.stack([128 + 100 * np.sin(6 * x + 3 * y + 1 + 0.3 * i),
                    128 + 90 * np.cos(9 * y + 0.5 - 0.2 * i),
                    128 + 60 * np.sin(5 * (x + y) + 0.1 * i)], -1)
    img += rng.normal(0, 2, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def tooling_masks():
    """The segmentation's (TOOL_FRAMES, 540, 960) bool stack: per frame one
    body-shaped blob (head, torso, arms, legs) with a hole in the torso,
    moved and swung by seeded amounts."""
    import numpy as np
    h, w = TOOL_MASK
    rng = np.random.default_rng(SEED + 99)
    yy, xx = np.mgrid[0:h, 0:w]

    def ellipse(cx, cy, a, b, theta=0.0):
        u = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
        v = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
        return (u / a) ** 2 + (v / b) ** 2 < 1

    out = np.zeros((TOOL_FRAMES, h, w), bool)
    for i in range(TOOL_FRAMES):
        cx, cy = 480 + rng.uniform(-40, 40), 270 + rng.uniform(-15, 15)
        swing = rng.uniform(-0.3, 0.3)
        m = ellipse(cx, cy - 170, 32, 40)                        # head
        m |= ellipse(cx, cy - 30, 70, 110)                       # torso
        m |= ellipse(cx - 95, cy - 40, 18, 95, 0.5 + swing)      # arms
        m |= ellipse(cx + 95, cy - 40, 18, 95, -0.5 - swing)
        m |= ellipse(cx - 35, cy + 150, 22, 100, 0.1 - swing)    # legs
        m |= ellipse(cx + 35, cy + 150, 22, 100, -0.1 + swing)
        m &= ~ellipse(cx + 10, cy - 20, 16, 28)                  # the hole
        out[i] = m
    return out


def tooling_keypoints():
    """(24, 3) seeded keypoints over the first frame: some off the image,
    some with no confidence, the head-top joint's set (MPII bones)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 98)
    h, w = TOOL_RAW
    kp = np.stack([rng.uniform(-100, w + 100, 24),
                   rng.uniform(-100, h + 100, 24),
                   rng.uniform(-0.3, 1.0, 24)], 1)
    kp[13, 2] = 0.9
    return kp


class StandInVideo:
    """`motion/streams.VideoStream`'s interface over the seeded frames (the
    path is not opened)."""

    def __init__(self, path, focal=None):
        self.height, self.width = TOOL_RAW
        self.fps = 30.0
        self.n_frames = TOOL_FRAMES

    def __len__(self):
        return self.n_frames

    def __iter__(self):
        for i in range(self.n_frames):
            yield tooling_frame(i)

    def release(self):
        pass


class ToolTimes:
    """While installed (it may be entered more than once), the host time
    (device synced) of each call of the build's Lanczos resize, JPEG
    write, PNG write and `mask_to_yolo_txt`."""

    def __init__(self):
        self.ms = {}
        self._undo = []

    def _wrap(self, obj, name, label):
        fn = getattr(obj, name)
        ms = self.ms.setdefault(label, [])

        def timed_call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            return out
        self._undo.append((obj, name, fn))
        setattr(obj, name, timed_call)

    def __enter__(self):
        from gsavatar_torch import native
        from gsavatar_torch.data import image_ops
        from gsavatar_torch.tooling import build_dataset
        from gsavatar_torch.utils import png
        self._wrap(image_ops, 'resize_lanczos4', 'Lanczos-4 mask resize')
        self._wrap(native, 'write_jpeg', 'JPEG write')
        self._wrap(png, 'write_png', 'PNG write')
        self._wrap(build_dataset, 'mask_to_yolo_txt',
                   'mask_to_yolo_txt (PNG read, contours, fill)')
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._undo):
            setattr(obj, name, fn)


def add_rest_shape(models_dir, assets):
    """Each SMPL npz of `models_dir` rewritten with the rest shape of its
    betas (`v_template + shapedirs @ betas`), the `minimal_shape` the
    ZJU-MoCap loader reads and step 4 does not write."""
    import numpy as np
    for name in sorted(os.listdir(models_dir)):
        path = os.path.join(models_dir, name)
        payload = dict(np.load(path))
        payload['minimal_shape'] = (assets.v_template + np.einsum(
            'vcl,l->vc', assets.shapedirs, payload['betas'][0])).astype(
                np.float32)
        np.savez(path, **payload)


def build_tooling_tree(root, device, times=None):
    """Steps 2-6 of the port's `tooling.build_dataset` on the seeded video
    and masks: the ZJU tree `root/S1` (`1/*.jpg`, `1/*.png`,
    `cam_params.json`, `models/*.npz` from a TOOL_FRAMES-frame CLIFF
    motion, its translation kept (step 4's default zeroes it, and the
    camera sits at the origin) and the rest shape added for the loader),
    the YOLO copies `root/yolo`, and the YOLO text and recovered mask of
    each frame under `root/txt`. Returns the recovered masks."""
    import numpy as np
    from gsavatar_torch.motion import streams
    from gsavatar_torch.smpl.body_model import find_assets
    from gsavatar_torch.tooling import build_dataset as bd
    subj = os.path.join(root, 'S1')
    os.makedirs(subj, exist_ok=True)
    masks_path = os.path.join(root, 'masks.npy')
    np.save(masks_path, tooling_masks())
    video = streams.VideoStream
    streams.VideoStream = StandInVideo
    try:
        with times or contextlib.nullcontext():
            n = bd.extract_images_and_masks(os.path.join(root, 'video.mp4'),
                                            masks_path, subj, device=device)
    finally:
        streams.VideoStream = video
    if n != TOOL_FRAMES:
        fail(f"extract_images_and_masks wrote {n} frames")
    bd.generate_camera_params(TOOL_RAW[1], TOOL_RAW[0],
                              os.path.join(subj, 'cam_params.json'))
    motion = motion_npz(os.path.join(root, 'cliff.npz'), TOOL_FRAMES)
    assets = find_assets(None, 'neutral')
    bd.extract_smpl_model_data(motion, os.path.join(subj, 'models'), assets,
                               flip_root=False, device=device)
    add_rest_shape(os.path.join(subj, 'models'), assets)
    bd.build_yolo_seg_dataset(os.path.join(subj, '1'),
                              os.path.join(root, 'yolo'))
    os.makedirs(os.path.join(root, 'txt'), exist_ok=True)
    recovered = []
    with times or contextlib.nullcontext():
        for i in range(TOOL_FRAMES):
            recovered.append(bd.mask_to_yolo_txt(
                os.path.join(root, 'yolo', 'masks', f'{i:06d}.png'),
                os.path.join(root, 'txt', f'{i:06d}.txt')))
    return recovered


def tooling_overlays():
    """The skeleton overlay (BGR) and `cliff.process_image` (CHW and the
    crop) of the first frame, the crop around its mask's bounding box."""
    import numpy as np
    from gsavatar_torch.tooling import cliff, skeleton
    rgb = tooling_frame(0)
    over = skeleton.draw_skeleton(np.ascontiguousarray(rgb[..., ::-1]),
                                  tooling_keypoints(), 3, 5)
    ys, xs = np.nonzero(tooling_masks()[0])
    bbox = [2.0 * xs.min(), 2.0 * ys.min(), 2.0 * xs.max(), 2.0 * ys.max()]
    norm, _, _, _, _, crop = cliff.process_image(rgb, bbox)
    return {'skeleton overlay': over, 'process_image': norm,
            'process_image crop': crop}


def tooling_digests(root, recovered, overlays):
    """The SHA-256 of each output of the build: each JPEG's bytes, each
    PNG mask's pixels (its zlib stream is the writer's own), the camera
    JSON's bytes, each YOLO text's bytes and recovered mask, and the
    `overlays` arrays."""
    from gsavatar_torch.utils import png
    out = {}
    subj = os.path.join(root, 'S1')
    for i in range(TOOL_FRAMES):
        name = f'{i:06d}'
        with open(os.path.join(subj, '1', f'{name}.jpg'), 'rb') as f:
            out[f'{name}.jpg'] = hashlib.sha256(f.read()).hexdigest()
        out[f'{name}.png pixels'] = _sha(png.read_png(
            os.path.join(subj, '1', f'{name}.png'), 'gray'))
        with open(os.path.join(root, 'txt', f'{name}.txt'), 'rb') as f:
            out[f'{name}.txt'] = hashlib.sha256(f.read()).hexdigest()
        out[f'{name} recovered mask'] = _sha(recovered[i])
    with open(os.path.join(subj, 'cam_params.json'), 'rb') as f:
        out['cam_params.json'] = hashlib.sha256(f.read()).hexdigest()
    for k, v in overlays.items():
        out[k] = _sha(v)
    return out


def tooling_models_close(root, device):
    """Step 4 on `device` against the same step on the CPU: every array of
    every models/*.npz within 1e-5 (absolute and relative), the keys and
    dtypes equal."""
    import numpy as np
    from gsavatar_torch.smpl.body_model import find_assets
    from gsavatar_torch.tooling import build_dataset as bd
    ref = os.path.join(root, 'models_cpu')
    assets = find_assets(None, 'neutral')
    bd.extract_smpl_model_data(os.path.join(root, 'cliff.npz'), ref, assets,
                               flip_root=False, device='cpu')
    add_rest_shape(ref, assets)
    worst = 0.0
    for i in range(TOOL_FRAMES):
        a = np.load(os.path.join(root, 'S1', 'models', f'{i:06d}.npz'))
        b = np.load(os.path.join(ref, f'{i:06d}.npz'))
        if sorted(a.files) != sorted(b.files):
            fail(f"models/{i:06d}.npz keys {a.files} against {b.files}")
        for k in b.files:
            if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape:
                fail(f"models/{i:06d}.npz {k}: {a[k].dtype} {a[k].shape}")
            d = np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))
            if not np.all(d <= 1e-5 + 1e-5 * np.abs(b[k])):
                fail(f"models/{i:06d}.npz {k} off the CPU's by {d.max()}")
            worst = max(worst, float(d.max()))
    return worst


def tooling_preload(root, gpu):
    """`native.decode_batch` on one thread and on every CPU, and a
    `Prefetcher` over a seeded schedule, on the tree: each frame and mask
    equal bit for bit to `zju_format.load_image_mask`'s."""
    import glob as globmod
    import numpy as np
    from gsavatar_torch import native
    from gsavatar_torch.data import zju_format
    subj = os.path.join(root, 'S1')
    imgs = sorted(globmod.glob(os.path.join(subj, '1', '*.jpg')))
    masks = sorted(globmod.glob(os.path.join(subj, '1', '*.png')))
    with open(os.path.join(subj, 'cam_params.json')) as f:
        cp = json.load(f)['1']
    K = np.array(cp['K'], np.float32)
    D = np.array(cp['D'], np.float32).ravel()
    hw = (512, 512)          # the custom-video config's img_hw
    want = [zju_format.load_image_mask(i, m, K, D, hw, False, device=DEVICE)
            for i, m in zip(imgs, masks)]
    n_cpu = os.cpu_count() or 1
    for threads in (1, n_cpu):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_i, got_m = native.decode_batch(imgs, masks, K, D, hw, False,
                                           n_threads=threads, device=DEVICE)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(imgs)
        for j, (wi, wm) in enumerate(want):
            if not (torch.equal(got_i[j], wi) and torch.equal(got_m[j], wm)):
                fail(f"decode_batch ({threads} threads): frame {j} differs "
                     f"from load_image_mask")
        log(f"tooling preload ({gpu}): decode_batch of {len(imgs)} frames "
            f"{TOOL_RAW[1]}x{TOOL_RAW[0]} -> {hw[1]}x{hw[0]} on {threads} "
            f"thread(s) of os.cpu_count() = {n_cpu}: {ms:.2f} ms/frame "
            f"(host clock, synced), bit-equal to load_image_mask")
    order = np.random.default_rng(SEED + 97).permutation(len(imgs))
    pf = native.Prefetcher(imgs, masks, K, D, hw, False, lookahead=4,
                           n_threads=n_cpu, device=DEVICE)
    try:
        pf.set_schedule(order)
        t0 = time.perf_counter()
        seen = []
        while True:
            item = pf.next()
            if item is None:
                break
            idx, im, mk = item
            seen.append(idx)
            if not (torch.equal(im, want[idx][0])
                    and torch.equal(mk, want[idx][1])):
                fail(f"Prefetcher: frame {idx} differs from load_image_mask")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(imgs)
    finally:
        pf.close()
    if seen != [int(i) for i in order]:
        fail(f"Prefetcher gave {seen}, scheduled {order.tolist()}")
    log(f"tooling preload ({gpu}): Prefetcher over a seeded schedule, "
        f"{n_cpu} threads, lookahead 4: {ms:.2f} ms/frame (host clock, "
        f"synced), bit-equal to load_image_mask")


def tooling_training(root, counters, gpu):
    """`train.training` with `dataset=zjumocap_001_mono` (the custom-video
    loader) on the built tree at the bench's point count: TOOL_STEPS
    iterations, validation at TOOL_VAL with the strips saved, a
    torch.profiler trace over TOOL_TRACE; then K1 and K2 against their
    plain versions on one more step's inputs. The 1920x1080 frames go to
    the config's 512x512, so a splat is 1.78x taller than wide: the rect
    window is 16 tiles, where 8 crops about 36 of the 50,000 initial
    Gaussians."""
    from gsavatar_torch import train
    from gsavatar_torch.config import load_config
    from gsavatar_torch.ops.rasterizer import composite as K
    from gsavatar_torch.scene import Scene
    from gsavatar_torch.utils import png
    exp = os.path.join(root, 'exp')
    trace_dir = os.path.join(root, 'trace')
    cfg = load_config([
        'dataset=zjumocap_001_mono', f'dataset.root_dir={root}',
        'dataset.subject=S1', f'dataset.train_frames=[0,{TOOL_FRAMES},1]',
        f'dataset.val_frames=[0,{TOOL_FRAMES},4]',
        'dataset.n_points=50000', 'rasterizer.max_rect=16',
        f'opt.iterations={TOOL_STEPS}',
        'test_interval=0', f'test_iterations={list(TOOL_VAL)}',
        f'max_val_frames={TOOL_VAL_FRAMES}', 'save_val_images=true',
        f'profile_trace_dir={trace_dir}',
        f'profile_start_iter={TOOL_TRACE[0]}',
        f'profile_stop_iter={TOOL_TRACE[1]}', 'strict_overflow=true',
        f'exp_dir={exp}'])
    t0 = time.perf_counter()
    scene = Scene(cfg, seed=SEED, device=DEVICE)
    cams = [scene.train_dataset[i] for i in range(len(scene.train_dataset))]
    torch.cuda.synchronize()
    log(f"tooling tree scene ({gpu}): {len(cams)} training frames "
        f"{tuple(cams[0].image.shape)} preloaded, "
        f"{int(scene.init_state().gauss_aux.alive.sum())} Gaussians, "
        f"{time.perf_counter() - t0:.2f} s")
    with StepTimes(train, 'make_train_step') as st:
        (scene, state, logger), launches = driven(
            counters, lambda: train.training(cfg, scene=scene, log_every=1,
                                             progress=False))
    check_finite_records(logger, 'tooling tree training')
    n_val = sum(min(n, TOOL_VAL_FRAMES) for n in (
        len(scene.test_dataset),
        len(range(0, len(scene.train_dataset),
                  max(len(scene.train_dataset) // 10, 1)))))
    want = {'composite_fwd': TOOL_STEPS + n_val * len(TOOL_VAL),
            'composite_bwd': TOOL_STEPS,
            'segsum': K3_PER_STEP * TOOL_STEPS, 'narrow_rows': 0,
            'conv_adam': K5_PER_STEP * TOOL_STEPS}
    losses = list(rows(logger, 'loss/total_loss').values())
    log(f"tooling tree training ({gpu}): {TOOL_STEPS} steps, median "
        f"{st.median():.3f} ms/step without the first (first "
        f"{st.ms[0]:.1f}), loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
        f"launches {launches} (expected {want})")
    if launches != want:
        fail(f"tooling tree launches {launches}, expected {want}")
    strips = []
    for it in TOOL_VAL:
        d = os.path.join(exp, 'validation', f'iter_{it}')
        names = sorted(os.listdir(d)) if os.path.isdir(d) else []
        if len(names) != n_val:
            fail(f"validation strips at {it}: {names}")
        for name in names:
            s = png.read_png(os.path.join(d, name))
            h, w = cfg['dataset']['img_hw']
            if s.shape != (h, 3 * w, 3):
                fail(f"strip {name}: {s.shape}")
            strips.append(name)
    trace = os.path.join(trace_dir,
                         f'trace_{TOOL_TRACE[0]}_{TOOL_TRACE[1]}.json')
    if not os.path.exists(trace):
        fail(f"no trace at {trace}")
    with open(trace) as f:
        text = f.read()
    missing = [k for k, v in TRACE_NAMES.items() if v not in text]
    if missing:
        fail(f"the trace names no kernel of {missing}")
    log(f"tooling tree validation: {len(strips)} strips (H, 3W, 3) at "
        f"{list(TOOL_VAL)}; trace {os.path.basename(trace)} "
        f"{len(text) / 2 ** 20:.1f} MiB names {sorted(TRACE_NAMES.values())}")
    # K1 and K2 against their plain versions on one more step's inputs
    weights = train.loss_weights(cfg, TOOL_STEPS)
    weights['_in_densify_window'] = 1.0
    _, _, seen = capture_kernel_inputs(scene, state, cams[0], weights,
                                       scene.bucket_for(int(
                                           state.gauss_aux.alive.sum())))
    pd, ts, ct, fwd, grid_x = seen['k2'][0]
    got = K.composite_pairs_fwd(pd, ts, grid_x)
    k1_err = float((got - K.composite_pairs_fwd_plain(pd, ts, grid_x))
                   .abs().max())
    g2 = K.composite_pairs_bwd(pd, ts, ct, fwd, grid_x)
    w2 = K.composite_pairs_bwd_plain(pd, ts, ct, fwd, grid_x)
    scale = K.composite_pairs_bwd_scale(pd, ts, ct, fwd, grid_x)
    k2_off = int(((g2 - w2).abs() > K2_TOL * scale).sum())
    log(f"tooling tree kernels on {pd.shape[0]} pairs: K1 max abs err "
        f"{k1_err:.3e} (tolerance {K1_TOL:g}), K2 {k2_off} values off "
        f"(tolerance {K2_TOL:g} of each value's scale), max abs err "
        f"{float((g2 - w2).abs().max()):.3e}")
    if not k1_err <= K1_TOL or k2_off:
        fail("the kernels disagree with their plain versions on the "
             "tooling tree")


def dummy_camera_phase(counters, gpu):
    """`dummy_dataset` with `use_camera=True`: the card has no webcam and
    no OpenCV, so the dataset serves the synthetic pose track, equal to
    `use_camera=False`'s; one frame rendered through K1."""
    from gsavatar_torch.config import load_config
    from gsavatar_torch.data import load_dataset
    from gsavatar_torch.inference import InferenceScene, init_state
    cfg = load_config(['dataset.name=dummy_dataset', 'dataset.n_verts=512',
                       'dataset.img_hw=[64,64]', 'dataset.n_points=768',
                       'model.gaussian.capacity=1024'])
    del cfg['dataset']['train_frames']
    plain = load_dataset(dict(cfg['dataset']), 'train', device=DEVICE)
    cam_cfg = dict(cfg['dataset'], use_camera=True)
    live = load_dataset(cam_cfg, 'train', device=DEVICE)
    if live._stream is not None:
        fail("dummy_dataset opened a camera on the card's machine")
    if len(live) != len(plain) or live.frames != list(range(
            live.N_PREBUILT)):
        fail(f"dummy_dataset: {len(live)} cameras, {len(plain)} without the "
             f"camera")
    for i in (0, len(live) // 2, len(live) - 1):
        a, b = live[i], plain[i]
        if not (torch.equal(a.image, b.image) and torch.equal(a.mask, b.mask)
                and torch.equal(a.world_view_transform,
                                b.world_view_transform)
                and a.image_name == b.image_name):
            fail(f"dummy_dataset use_camera=True frame {i} differs")
    state = init_state(cfg, live, device=DEVICE)
    scene = InferenceScene(cfg, live.metadata, live.assets, state,
                           device=DEVICE)
    pkg, launches = driven(counters,
                           lambda: scene.render_frame(live[0]))
    log(f"dummy_dataset use_camera=True ({gpu}): no camera, the "
        f"{live.N_PREBUILT}-frame pose track ({len(live)} cameras) equal to "
        f"use_camera=False; one frame rendered, launches {launches}")
    if launches['composite_fwd'] != 1 or not bool(
            pkg.render.isfinite().all()):
        fail(f"dummy_dataset render: launches {launches}")


def tooling_phase(counters, work, gpu):
    """Phase 16: the custom-video tooling on the card."""
    import numpy as np
    with open(os.path.join(TOOL_FIXTURES, 'digests.json')) as f:
        want = json.load(f)
    t0 = time.perf_counter()
    times = ToolTimes()
    recovered = build_tooling_tree(work, DEVICE, times)
    build_s = time.perf_counter() - t0
    got = tooling_digests(work, recovered, tooling_overlays())
    bad = sorted(k for k in want if want[k] != got.get(k))
    log(f"tooling tree ({gpu}): {TOOL_FRAMES} frames {TOOL_RAW[1]}x"
        f"{TOOL_RAW[0]}, masks {TOOL_MASK[1]}x{TOOL_MASK[0]}, steps 2-6 in "
        f"{build_s:.2f} s; digests {len(want) - len(bad)} of {len(want)} "
        f"equal to the fixture's")
    if bad or set(got) != set(want):
        fail(f"the tooling's outputs differ from the fixture's: {bad}")
    for label, ms in times.ms.items():
        per = sorted(ms)
        log(f"tooling {label} ({gpu}): {sum(ms) / TOOL_FRAMES:.2f} ms/frame "
            f"(median {per[len(per) // 2]:.2f} ms per call, {len(ms)} "
            f"calls; host clock, device synced)")
    log(f"tooling step 4 on the card against the CPU: largest difference "
        f"{tooling_models_close(work, DEVICE):.3e}")
    n_poly = [int(np.count_nonzero(r)) for r in recovered]
    log(f"tooling recovered masks: {min(n_poly)}..{max(n_poly)} pixels")
    tooling_preload(work, gpu)
    tooling_training(work, counters, gpu)
    dummy_camera_phase(counters, gpu)


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
    scene, cams = synthetic_scene(BENCH_OVERRIDES, SEED, DEVICE)
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
        rc = scene.raster_config
        if img.shape != (rc.height, rc.width, 3) \
                or not bool(img.isfinite().all()):
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
    small, small_cams = synthetic_scene(SMALL_SHAPE, SEED, DEVICE)
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

    # 6-8. the training path, its kernels, and its reference
    step_records, k2_args = train_phases()
    records += step_records

    # 9. the training run, a resume, predict; 10. the probe
    counters = kernel_counters()
    if counters['narrow_rows'].launches:
        fail("K4 launched on the render or training path")
    # the runs' checkpoints (about 90 MB each) go under build/, which the
    # repository ignores, and are removed at the end
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix='run-', dir=kernels.BUILD)
    serve_work = tempfile.mkdtemp(prefix='serve-', dir=kernels.BUILD)
    try:
        try:
            cfg, probe, driver_launches = driver_phase(counters, work)
            resume_and_predict(cfg, work, probe, counters)
            # phase 13 serves the last checkpoint written, the resumed
            # run's: ckpt40 follows the opacity reset at 30, where every
            # opacity is at most 0.01 and no pixel reaches alpha 0.5
            ckpt = shutil.copy(os.path.join(
                work, 'resume', f'ckpt{RESUME_FROM + RESUME_ITERATIONS}.pt'),
                serve_work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        records.append(k4_phase(counters))
        records.append(k5_phase(driver_launches['conv_adam']))

        # 11. the real-format data path; its trees and frames under build/
        work = tempfile.mkdtemp(prefix='data-', dir=kernels.BUILD)
        try:
            real_data_phase(counters, work, gpu)
        finally:
            shutil.rmtree(work, ignore_errors=True)

        # 12. the model variants
        variant_phase(counters, gpu)

        # 13. the serving apps
        serving_phase(counters, ckpt, cfg, serve_work, gpu)
    finally:
        shutil.rmtree(serve_work, ignore_errors=True)

    # 14. multi-subject training and B frames per step; their checkpoints
    # under build/
    work = tempfile.mkdtemp(prefix='ms-', dir=kernels.BUILD)
    try:
        multi_subject_phase(counters, work, gpu)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 15. the mesh; its ranks' files under build/
    work = tempfile.mkdtemp(prefix='mesh-', dir=kernels.BUILD)
    try:
        mesh_phase(counters, work, gpu, (pa.pair_data, pa.tile_start),
                   k2_args)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 16. the custom-video tooling; its tree, run and trace under build/
    work = tempfile.mkdtemp(prefix='tool-', dir=kernels.BUILD)
    t0 = time.perf_counter()
    try:
        tooling_phase(counters, work, gpu)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")

    log(json.dumps({'kernels': records}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
