"""The arithmetic of the end-to-end and per-layer numbers: percentile,
rate, spread, and the trace's busy time, idle share, spans, kernels,
rooflines, MFU and idle gaps, on hand-made events."""
import statistics

import pytest

from perfbench.harness import timing, trace


def test_percentile_rate_spread():
    v = list(range(1, 101))
    assert timing.percentile(v, 95) == pytest.approx(95.05)
    assert timing.percentile([2.0, 4.0], 50) == pytest.approx(3.0)
    with pytest.raises(ValueError):
        timing.percentile([1.0], 95)
    assert timing.rate(30, 10.0) == 3.0
    q1, med, q3 = statistics.quantiles([1, 2, 3, 4, 5, 6], n=4)
    assert timing.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (q3 - q1) / med)


# device operations (name, start us, end us) and host spans over a 100 us
# slice: busy 0-20, 30-40 (overlapping ops merged), 70-80
DEVICE = [('(anonymous namespace)::composite_fwd_kernel(float const*, int)',
           0, 10),
          ('void at::native::k<4>(int)', 5, 20),
          ('segsum_chunks', 30, 40), ('composite_fwd_kernel(x)', 70, 80)]
SPANS = [('render/converter', 0, 50), ('rasterize/pairs', 22, 28),
         ('rasterize/pairs', 42, 48), ('bench/pose', 55, 68)]


def make():
    return trace.from_events(DEVICE, SPANS, 100e-6, 2,
                             {'k1_ops': 67e6, 'k1_bytes': 0, 'ops': 134e6},
                             {'rate': 1000.0})


def test_busy_idle_and_spans():
    t = make()
    assert t.busy_s == pytest.approx(40e-6)
    assert t.idle_share() == pytest.approx(60.0)
    assert t.per_unit_ms('render/converter') == pytest.approx(0.025)
    assert t.per_unit_ms('rasterize/pairs') == pytest.approx(0.006)
    assert t.per_call_ms('rasterize/pairs') == pytest.approx(0.006)
    assert t.per_unit_ms('train/losses') is None
    assert t.per_call_ms('bench/densify') is None


def test_kernels_by_name_rooflines_and_mfu():
    t = make()
    assert trace.kernel_name('void at::native::k<4>(int)') == 'k'
    assert trace.kernel_name('(anonymous namespace)::composite_fwd_kernel('
                             'float const*, int)') == 'composite_fwd_kernel'
    assert t.kernel_s('composite_fwd_kernel') == pytest.approx(20e-6)
    # 67e6 operations at 67 TFLOP/s take 1 us: 5% of 20 us
    assert t.roofline(('composite_fwd_kernel',), 'k1_ops', 'k1_bytes') \
        == pytest.approx(5.0)
    assert t.roofline(('composite_bwd_kernel',), 'k1_ops', 'k1_bytes') \
        is None
    # 67e6 operations a frame at 1000 frames/s: 0.1% of 67 TFLOP/s
    assert t.mfu() == pytest.approx(0.1)


def test_idle_gaps_go_to_the_innermost_span():
    gaps = dict(make().gaps)
    # 20-30 inside rasterize/pairs (22-28 covers the midpoint 25),
    # 40-70: midpoint 55, the start of bench/pose
    assert gaps == pytest.approx({'rasterize/pairs': 10e-6,
                                  'bench/pose': 30e-6})
    b = make().breakdown()
    assert b['device_ops'][0][1] == pytest.approx(15e-6)
    assert len(b['device_ops']) <= trace.TOP


def test_a_kernel_and_its_dependent_launch_count_their_union():
    # K3's carries pass starts before its chunks end (programmatic
    # dependent launch): 30-40 and 36-46 are 16 us, not 20
    t = trace.from_events(
        [('segsum_chunks', 30, 40), ('segsum_carries(int)', 36, 46),
         ('segsum_chunks', 60, 64)], [], 100e-6, 1,
        {'k3_ops': 67e6, 'k3_bytes': 0}, {})
    assert t.kernel_s('segsum_chunks', 'segsum_carries') \
        == pytest.approx(20e-6)
    assert t.kernel_s('segsum_chunks') == pytest.approx(14e-6)
    assert t.kernels_s['segsum_carries(int)'] == pytest.approx(10e-6)
    # 1 us of counted work over 20 us
    assert t.roofline(('segsum_chunks', 'segsum_carries'), 'k3_ops',
                      'k3_bytes') == pytest.approx(5.0)
