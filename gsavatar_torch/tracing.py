"""The port's one tracer: named spans, units and counters of the program.

    from gsavatar_torch import tracing
    tracing.enable()
    ...                       # frames or training steps
    tracing.disable()
    tracing.summary()         # {name: total ms, self ms, calls}
    tracing.records()         # one Record per span
    tracing.counters()        # {(unit, name): value}

`span(name)` marks a stage of the program (`render/converter`,
`converter/non_rigid`, `rasterize/pairs`, `train/backward`,
`update/arena`, `densify/knn`, ...). `unit(index, name)` opens the root
span of one frame or one training step: every span and counter inside it
carries `index` as its unit id, also the spans that autograd's device
thread opens in a custom backward (their parent is the span open on their
own thread). `count(name, value)` adds to a counter of the current unit.
`device_read(x)` is the program's host read of a device tensor,
`x.cpu()`: it counts `sync/reads` and adds the milliseconds the host
waited to `sync/wait_ms`.

Off (the default) a span costs one flag test and returns a shared no-op,
unless a `torch.profiler` is recording: then it is the
`record_function(name)` that profiler reads, as `device_read` is one named
`sync/read`. On, each span also appends one `Record` to a list kept in
memory until the next `enable()`; nothing is written while a unit runs.

One clock with the profiler: a record's `start_ns` and `end_ns` are read
with `time.time_ns`, the clock on which `torch.profiler` stamps its host
events: the start at the middle of the span's `record_function` enter,
which stamps the profiler's, the end just after its exit. The profiler's
times are microseconds from its trace start, so
`(start_ns - profiler_origin_ns(prof)) / 1e3` is the same span's start on
its timeline."""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _profiler
from torch.autograd.profiler import record_function

_now = time.time_ns


class Record(NamedTuple):
    id: int
    name: str
    unit: Optional[int]       # the unit open when the span opened
    parent: Optional[int]     # the id of the span open on the same thread
    thread: int
    start_ns: int
    end_ns: int


_NULL = contextlib.nullcontext()     # the shared span of a tracer that is off
_ON = False
_records: List[Record] = []
_counters: Dict[Tuple[Optional[int], str], float] = {}
_unit: Optional[int] = None
_ids = itertools.count()
_lock = threading.Lock()
_local = threading.local()


def _stack() -> list:
    st = getattr(_local, 'stack', None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ('name', 'index', 'rf', 'id', 'parent', 'unit', 'start',
                 'outer')

    def __init__(self, name: str, index: Optional[int] = None):
        self.name = name
        self.index = index       # set for the root span of a unit

    def __enter__(self):
        global _unit
        self.rf = None
        if _profiler._is_profiler_enabled:
            # the profiler stamps the span inside its enter call: its
            # middle is the nearest reading outside it
            self.rf = record_function(self.name)
            t0 = _now()
            self.rf.__enter__()
            self.start = (t0 + _now()) // 2
        else:
            self.start = _now()
        if self.index is not None:
            self.outer, _unit = _unit, self.index
        st = _stack()
        self.parent = st[-1] if st else None
        self.id = next(_ids)
        st.append(self.id)
        self.unit = _unit
        return self

    def __exit__(self, *exc):
        global _unit
        _stack().pop()
        if self.index is not None:
            _unit = self.outer
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _records.append(Record(self.id, self.name, self.unit, self.parent,
                               threading.get_ident(), self.start, _now()))
        return False


def span(name: str):
    """A context manager around one stage of the program."""
    if _ON:
        return _Span(name)
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _NULL


def unit(index: int, name: str):
    """The root span `name` of one frame or training step, whose spans
    and counters carry the unit id `index`."""
    if _ON:
        return _Span(name, int(index))
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _NULL


def count(name: str, value: float = 1.0) -> None:
    """Adds `value` to the current unit's counter `name`."""
    if not _ON:
        return
    key = (_unit, name)
    with _lock:
        _counters[key] = _counters.get(key, 0.0) + value


def device_read(x):
    """`x.cpu()`, the host's read of a device tensor, which waits for the
    work queued before it. On, it counts `sync/reads` and adds the host's
    wait to `sync/wait_ms`."""
    with span('sync/read'):
        t0 = _now()
        out = x.cpu()
        waited = _now() - t0
    count('sync/reads')
    count('sync/wait_ms', waited / 1e6)
    return out


def enable() -> None:
    """Turns the tracer on, with no records and no counters."""
    global _ON, _records, _counters
    _records, _counters = [], {}
    _ON = True


def disable() -> None:
    """Turns the tracer off; its records stay until the next `enable()`."""
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def records() -> List[Record]:
    """The spans closed since `enable()`, in the order they closed."""
    return list(_records)


def counters() -> Dict[Tuple[Optional[int], str], float]:
    """{(unit id, counter name): value} since `enable()`."""
    with _lock:
        return dict(_counters)


def summary(recs: Optional[List[Record]] = None) -> Dict[str, dict]:
    """By span name: `total_ms` (the durations summed), `self_ms` (each
    duration less the part of it that its child spans cover) and
    `calls`."""
    recs = records() if recs is None else recs
    child_ns: Dict[int, int] = {}
    for r in recs:
        if r.parent is not None:
            child_ns[r.parent] = child_ns.get(r.parent, 0) \
                + r.end_ns - r.start_ns
    out: Dict[str, dict] = {}
    for r in recs:
        s = out.setdefault(r.name, {'total_ms': 0.0, 'self_ms': 0.0,
                                    'calls': 0})
        d = r.end_ns - r.start_ns
        s['total_ms'] += d / 1e6
        s['self_ms'] += (d - child_ns.get(r.id, 0)) / 1e6
        s['calls'] += 1
    return out


def profiler_origin_ns(prof) -> int:
    """The start of a finished `torch.profiler.profile`'s trace, on the
    tracer's clock: the offset that puts a record on its timeline."""
    return int(prof.profiler.kineto_results.trace_start_ns())
