"""Where a rendered frame's or a training step's time goes on the card.

    python -m gsavatar_torch.profile_render [--frames 10] [--train]
                                            [--trace PATH]

Renders the synthetic avatar at the bench shape (`config.BENCH_OVERRIDES`,
seeded weights) through `InferenceScene.render_frame` or, with `--train`,
takes training steps of the same avatar through `Scene` and
`train.make_train_step` (bench.py's loss weights and learning rate at
iteration 1000): a few to warm up, then `--frames` of them, each a
`tracing.unit`, with the tracer on under `torch.profiler`. Prints per
frame or step the wall time (host clock, ended by a device sync), the
device's busy time (the union of its operations' intervals) and idle
share, the tracer's `summary()` (each span's total and self host ms and
calls) and counters (`sync/reads`, `sync/wait_ms`), and the kernels that
take the most device time. `--trace` also writes the Chrome trace. Needs
a CUDA GPU."""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gsavatar_torch import tracing
from gsavatar_torch.config import BENCH_OVERRIDES, load_config
from gsavatar_torch.device import resolve_device
from gsavatar_torch.inference import synthetic_scene

WARMUP = 3
TRAIN_ITERATION = 1000   # bench.py's loss weights and learning rate


def _render_frames(seed, dev):
    scene, cams = synthetic_scene(BENCH_OVERRIDES, seed, dev)
    cams = [c.to(dev) for c in cams]
    return lambda i: scene.render_frame(cams[i % len(cams)])


def _train_steps(seed, dev):
    from gsavatar_torch.scene import Scene
    from gsavatar_torch.train import loss_weights, make_train_step
    cfg = load_config(BENCH_OVERRIDES)
    scene = Scene(cfg, seed=seed, device=dev)
    state = scene.init_state()
    ds = scene.train_dataset
    cams = [ds[i] for i in range(len(ds))]
    bucket = scene.bucket_for(int(state.gauss_aux.alive.sum()))
    weights = dict(loss_weights(cfg, TRAIN_ITERATION), _in_densify_window=1.0)
    xyz_lr = scene.xyz_lr_fn(TRAIN_ITERATION)
    step = make_train_step(scene)
    # the step updates `state` in place
    return lambda i: step(state, cams[i % len(cams)], TRAIN_ITERATION + i,
                          weights, xyz_lr, bucket=bucket)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--frames', type=int, default=10)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--train', action='store_true',
                    help='profile training steps instead of frames')
    ap.add_argument('--trace', default=None)
    args = ap.parse_args(argv)
    dev = resolve_device('cuda')
    run = (_train_steps if args.train else _render_frames)(args.seed, dev)
    for i in range(WARMUP):
        run(i)
    torch.cuda.synchronize()

    unit = 'step' if args.train else 'frame'
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.frames):
            with tracing.unit(i, unit):
                run(WARMUP + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
    tracing.disable()
    if args.trace:
        prof.export_chrome_trace(args.trace)

    n = args.frames
    spans = {k: {m: x / n for m, x in v.items()}
             for k, v in tracing.summary().items()}
    counters = {}
    for (_, name), value in tracing.counters().items():
        counters[name] = counters.get(name, 0.0) + value / n
    # the device's own operations: kernels, copies and fills, without the
    # spans' annotations on the device's timeline
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)
              and e.name not in spans]
    if not device:
        raise SystemExit("the profiler recorded no device activity")
    # their union: kernels that programmatic dependent launch overlaps count
    # once
    busy_us, end = 0.0, float('-inf')
    for e in sorted(device, key=lambda e: e.time_range.start):
        busy_us += max(e.time_range.end - max(e.time_range.start, end), 0.0)
        end = max(end, e.time_range.end)
    busy_ms = busy_us / 1e3 / n
    by_name = {}
    for e in device:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / n,
                           count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"{n} {unit}s: wall {wall_ms:.3f} ms/{unit}, device busy "
          f"{busy_ms:.3f} ms/{unit}, idle share "
          f"{1.0 - busy_ms / wall_ms:.3f}, {len(device) / n:.0f} device "
          f"operations per {unit}")
    for k, v in sorted(spans.items(), key=lambda kv: -kv[1]['total_ms']):
        print(f"span {k}: {v['total_ms']:.3f} ms, self {v['self_ms']:.3f} "
              f"ms, {v['calls']:g} calls per {unit}")
    for k, v in counters.items():
        print(f"counter {k}: {v:.3f} per {unit}")
    for name, (ms, count) in top:
        print(f"  {ms:8.3f} ms x{count / n:5.0f}  {name[:100]}")
    print(json.dumps({'unit': unit, 'wall_ms': wall_ms,
                      'device_busy_ms': busy_ms,
                      'idle_share': 1.0 - busy_ms / wall_ms,
                      'device_ops_per_frame': len(device) / n,
                      'spans': spans, 'counters': counters,
                      'device': torch.cuda.get_device_name(0)}))


if __name__ == '__main__':
    main()
