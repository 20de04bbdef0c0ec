"""What a `--trace 1` run reads from `torch.profiler`: the device's busy
time (the union of its operations' intervals), the host spans
(`record_function` labels of the program and of the harness) and the
device time of each kernel by name, over one traced slice of the window.
The busy and span arithmetic is `gsavatar_torch/profile_render.py`'s,
copied: the spans show up twice, as host events and as annotations on
the device's timeline, and only the host events time a span.

`Trace` is what each reader in `metrics/` reads; `breakdown` is the
result line's list of the device operations that took most time and of
the longest idle gaps by the host span they fell in."""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# the card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
TOP = 10
NAME_CHARS = 160


def kernel_name(full: str) -> str:
    """A device operation's own name, without its return type, namespaces,
    template arguments and parameter list."""
    name = full.replace('(anonymous namespace)::', '')
    name = name.split('(')[0].split('<')[0].strip()
    return (name.split()[-1] if name else full).split('::')[-1]


def _merge(intervals: Sequence[Tuple[float, float]]):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Trace:
    units: int                       # frames or steps in the slice
    window_s: float                  # the slice's wall time, synced
    busy_s: float                    # seconds the device ran an operation
    spans_ms: Dict[str, float]       # host ms of each span, summed
    span_calls: Dict[str, int]
    kernels_s: Dict[str, float]      # device seconds by operation name
    kernel_spans: Dict[str, List[Tuple[float, float]]]   # their (start,
    #                                  end) in microseconds, by name
    counts: Dict[str, float]         # the work counted in the slice
    extra: Dict[str, float]          # what the cell's loop measured itself
    gaps: List[Tuple[str, float]]    # idle seconds by host span, longest first

    def per_unit_ms(self, *names: str) -> Optional[float]:
        """The host ms of the named spans per frame or step, or None when
        none ran in the slice."""
        if not any(self.span_calls.get(n) for n in names):
            return None
        return sum(self.spans_ms.get(n, 0.0) for n in names) / self.units

    def per_call_ms(self, name: str) -> Optional[float]:
        calls = self.span_calls.get(name, 0)
        return self.spans_ms[name] / calls if calls else None

    def kernel_s(self, *names: str) -> float:
        """The device seconds in which a kernel of these names ran, whatever
        signature the trace writes after a name: the union of their
        intervals, since a kernel launched with programmatic dependent
        launch (K2's combine pass, K3's carries) overlaps the one before."""
        spans = [iv for full, ivs in self.kernel_spans.items()
                 if kernel_name(full) in names for iv in ivs]
        return sum(e - s for s, e in _merge(spans)) / 1e6

    def roofline(self, kernels: Sequence[str], ops_key: str,
                 bytes_key: str) -> Optional[float]:
        """100 x the least time the chip could take for the counted work
        (the larger of bytes over peak bytes/s and operations over peak
        f32 operations/s) over the kernels' device time; None when they
        did not run."""
        t = self.kernel_s(*kernels)
        if t <= 0 or not self.counts.get(ops_key):
            return None
        bound = max(self.counts[bytes_key] / PEAK_BYTES,
                    self.counts[ops_key] / PEAK_F32)
        return 100.0 * bound / t

    def mfu(self, ops_key: str = 'ops') -> Optional[float]:
        """The counted operations of a frame or step at the untraced rate
        of the run (`extra['rate']`, frames or steps a second), over the
        peak, in %."""
        if not self.counts.get(ops_key) or not self.extra.get('rate'):
            return None
        return (100.0 * self.counts[ops_key] / self.units
                * self.extra['rate'] / PEAK_F32)

    def idle_share(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        ops = sorted(self.kernels_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {'device_ops': [[n[:NAME_CHARS], s] for n, s in ops],
                'idle_gaps': [[n, s] for n, s in self.gaps[:TOP]]}


def reduce(prof, window_s: float, units: int, counts: Dict[str, float],
           extra: Dict[str, float] = None) -> Trace:
    """A `Trace` from a finished `torch.profiler.profile`: its device
    operations (the CUDA events that are not span annotations) and its
    host spans (the `record_function` labels)."""
    from torch.autograd import DeviceType
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    span_names = {e.name for e in host
                  if getattr(e, 'is_user_annotation', False)}
    device = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)
              and e.name not in span_names]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in host
             if e.name in span_names]
    return from_events(device, spans, window_s, units, counts, extra)


def from_events(device, spans, window_s: float, units: int,
                counts: Dict[str, float], extra: Dict[str, float] = None
                ) -> Trace:
    """A `Trace` from (name, start_us, end_us) device operations and host
    spans."""
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    busy = _merge([(s, e) for _, s, e in device])
    busy_s = sum(e - s for s, e in busy) / 1e6
    spans_ms: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for name, s, e in spans:
        spans_ms[name] = spans_ms.get(name, 0.0) + (e - s) / 1e3
        calls[name] = calls.get(name, 0) + 1
    kernels: Dict[str, float] = {}
    kernel_spans: Dict[str, List[Tuple[float, float]]] = {}
    for name, s, e in device:
        kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e6
        kernel_spans.setdefault(name, []).append((s, e))
    return Trace(units, window_s, busy_s, spans_ms, calls, kernels,
                 kernel_spans, dict(counts), dict(extra or {}),
                 _gaps(busy, [(s, e, n) for n, s, e in spans]))


def _gaps(busy, spans) -> List[Tuple[str, float]]:
    """The idle time between the device's busy intervals, each gap given to
    the innermost host span that covers its midpoint ('host' where none
    does), summed by span and sorted longest first."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    longest = max((e - s for s, e, _ in spans), default=0.0)
    out: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        best, best_len = 'host', None
        j = bisect.bisect_right(starts, mid) - 1
        while j >= 0 and starts[j] >= mid - longest:
            s, e, name = spans[j]
            if mid <= e and (best_len is None or e - s < best_len):
                best, best_len = name, e - s
            j -= 1
        out[best] = out.get(best, 0.0) + (s1 - e0) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])
