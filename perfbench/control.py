"""The readings that set a cell's limits, on the chip at the cell's own
size: for each seed, one run of the cell with a short window (the
program's readings against the plain reference) and the control's (the
reference in the program's place with its f32 products in TF32, against
the reference in f32). All seeds in one process.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3
                                 [--seconds 4]

Prints one JSON line a seed: {"seed", "attempted", "program": {...},
"control": {...}, "diag": {...}}, the diagnostics with each checked
step's loss gap, the program's and the control's."""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=4.0)
    ap.add_argument('--fault', choices=('none', 'pixel'), default='none',
                    help="'pixel': the program's render altered where it is "
                         "produced, one pixel's colour off by 0.5")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import env
    env.fix_threads()
    import torch
    from perfbench.harness import registry
    env.torch_threads(torch)
    cell = registry.cell(args.workload)
    # a training cell's settle rounds come after its checked steps and
    # change none of its readings
    cell.traffic['settle_rounds'] = 0
    if not torch.cuda.is_available():
        print("the control runs on a CUDA GPU", file=sys.stderr)
        return 3
    driver = registry.driver(cell.traffic)
    if args.fault == 'pixel':
        plant_pixel_fault()
    for seed in (int(s) for s in args.seeds.split(',')):
        out = driver.run(cell, seed, args.seconds, False, device='cuda',
                         control=True)
        print(json.dumps({'seed': seed, 'attempted': out['attempted'],
                          'program': out['readings'],
                          'control': out['control'],
                          'diag': out.get('diag')}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


def plant_pixel_fault(delta: float = 0.5):
    """The program's `render` (as the training step and the inference scene
    call it) returns an image with pixel (0, 0) off by `delta` in every
    channel, inside the autograd graph."""
    import torch
    from gsavatar_torch import inference, renderer, train

    def faulty(*args, **kwargs):
        pkg = renderer.render(*args, **kwargs)
        off = torch.zeros_like(pkg.render)
        off[0, 0] = delta
        return pkg._replace(render=pkg.render + off)

    train.render = inference.render = faulty


if __name__ == '__main__':
    sys.exit(main())
