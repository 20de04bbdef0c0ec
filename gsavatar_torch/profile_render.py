"""Where a rendered frame's time goes on the card.

    python -m gsavatar_torch.profile_render [--frames 10] [--trace PATH]

Renders the synthetic avatar at the bench shape (`config.BENCH_OVERRIDES`,
seeded weights) through `InferenceScene.render_frame`: a few frames to warm
up, then `torch.profiler` over `--frames` frames. Prints the wall time per
frame (host clock, ended by a device sync), the device's busy time per frame
(the sum of its kernel and copy times), the idle share, each stage span's
host and device time (`render/converter`, `rasterize/*`), and the kernels
that take the most device time. `--trace` also writes the Chrome trace.
Needs a CUDA GPU."""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gsavatar_torch.config import BENCH_OVERRIDES
from gsavatar_torch.device import resolve_device
from gsavatar_torch.inference import synthetic_scene

WARMUP = 3
SPANS = ('render/', 'rasterize/')


def _us(event) -> float:
    return event.time_range.end - event.time_range.start


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--frames', type=int, default=10)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--trace', default=None)
    args = ap.parse_args(argv)
    dev = resolve_device('cuda')
    scene, cams = synthetic_scene(BENCH_OVERRIDES, args.seed, dev)
    cams = [c.to(dev) for c in cams]
    for i in range(WARMUP):
        scene.render_frame(cams[i % len(cams)])
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.frames):
            scene.render_frame(cams[i % len(cams)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
    if args.trace:
        prof.export_chrome_trace(args.trace)

    n = args.frames
    events = prof.events()
    # the device's own events: kernels, copies and fills; the spans appear
    # twice, on the host and as annotations on the device's timeline
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith(SPANS)]
    if not device:
        raise SystemExit("the profiler recorded no device activity")
    busy_ms = sum(_us(e) for e in device) / 1e3 / n
    spans = {}
    for e in events:
        if not e.name.startswith(SPANS):
            continue
        rec = spans.setdefault(e.name, {'host_ms': 0.0, 'device_ms': 0.0})
        if e.device_type == DeviceType.CUDA:
            # device time of the work inside the span's device interval
            t0, t1 = e.time_range.start, e.time_range.end
            inside = sum(_us(k) for k in device if t0 <= k.time_range.start
                         and k.time_range.end <= t1)
            rec['device_ms'] += inside / 1e3 / n
        else:
            rec['host_ms'] += _us(e) / 1e3 / n
    by_name = {}
    for e in device:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + _us(e) / 1e3 / n, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"{n} frames: wall {wall_ms:.3f} ms/frame, device busy "
          f"{busy_ms:.3f} ms/frame, idle share "
          f"{1.0 - busy_ms / wall_ms:.3f}, {len(device) / n:.0f} device "
          f"operations per frame")
    for k, v in spans.items():
        print(f"span {k}: host {v['host_ms']:.3f} ms, device "
              f"{v['device_ms']:.3f} ms per frame")
    for name, (ms, count) in top:
        print(f"  {ms:8.3f} ms x{count / n:5.0f}  {name[:100]}")
    print(json.dumps({'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
                      'idle_share': 1.0 - busy_ms / wall_ms,
                      'device_ops_per_frame': len(device) / n,
                      'spans': spans,
                      'device': torch.cuda.get_device_name(0)}))


if __name__ == '__main__':
    main()
