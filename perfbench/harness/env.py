"""The benchmark process's own host settings: one intra-op thread for
torch, OpenMP and MKL (set before torch is imported), and after warm-up a
collected and frozen heap, so that no collection in the window walks
set-up's objects. They act on this process only; no setting of the
machine is touched. The process keeps every core it is allowed: pinned
to four of the card machine's eight, the training step ran 9% slower and
no steadier (PERF.md, the steadiness study)."""
from __future__ import annotations

import gc
import os

THREADS = 1
THREAD_VARS = ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS')


def fix_threads() -> None:
    """Before torch is imported."""
    for var in THREAD_VARS:
        os.environ[var] = str(THREADS)


def torch_threads(torch) -> None:
    torch.set_num_threads(THREADS)


def settle() -> None:
    """After warm-up: collect, then move what survives out of the
    collector's generations."""
    gc.collect()
    gc.freeze()
