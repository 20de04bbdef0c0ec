"""The benchmark of gsavatar_torch: one cell a run.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Runs the cell `<name>` of BENCHMARK.json on this machine's GPU: set-up
(the inputs and weights from the seed, the program's scene, warm-up), a
window of `--seconds` seconds, then the check of what the window produced
against the plain reference. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics; with `--trace 1` its per-layer metrics, read from a profiler
trace of a slice of the window), `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared beside its limit, which also end
standard error. Without a CUDA GPU, or with fewer than the cell asks for,
it prints no result and exits 3."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the top-level modules that may not be loaded once the window has closed:
# JAX and the JAX package the port was made from
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'gsavatar')


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of FORBIDDEN, compared whole."""
    return sorted({n for n in names if n.split('.')[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'not read'


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from perfbench.harness import env
    env.fix_threads()
    # every build cache of the program inside the checkout, at fixed paths
    os.environ['TORCH_EXTENSIONS_DIR'] = str(ROOT / 'build' / 'torch_ext')
    os.environ['TRITON_CACHE_DIR'] = str(ROOT / 'build' / 'triton')
    import torch
    from perfbench.harness import check, registry

    cell = registry.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA GPU(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    env.torch_threads(torch)
    out = registry.driver(cell.traffic).run(
        cell, args.seed, args.seconds, bool(args.trace), device='cuda')

    found = forbidden_modules(sys.modules)
    if found:
        print(f"the process loaded {found}: the benchmark runs the port "
              f"without JAX or the JAX package", file=sys.stderr)
        return 4
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': cell.chips,
              'memory_peak_bytes': int(out['memory_peak_bytes'])}
    result = {'attempted': out['attempted'], 'failed': out['failed']}
    units = {m['name']: m['unit'] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        t = out['trace']
        metrics = {}
        for name, read in registry.readers(
                [m['name'] for m in cell.per_layer]).items():
            value = read(t)
            if value is not None:
                metrics[name] = {'value': value, 'unit': units[name]}
        device['busy_s'] = t.busy_s
        device['window_s'] = t.window_s
        result['breakdown'] = t.breakdown()
    else:
        metrics = {k: {'value': v, 'unit': units[k]}
                   for k, v in out['metrics'].items()}
        metrics['setup_s'] = {'value': out['t0'] - T_START, 'unit': 's'}
    correct, checks = check.judge(out['readings'], cell.limits)
    result.update(correct=correct, metrics=metrics, device=device,
                  card={'power_limit': power_limit(),
                        'pairs_dropped': out['pairs_dropped'],
                        'window': out.get('diag')},
                  checks=checks)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
