"""The readers of the program's stage spans and host reads: each gives its
span's host ms (or, for `syncs.serve`, its count) a frame or step of the
traced slice, `knn_ms.train` ms a round, and None where its span did not
run; and a `--trace 0` run leaves the program's tracer off."""
import pytest

from perfbench.harness import registry, trace

# two traced frames or steps over 100 us, one device operation
DEVICE = [('composite_fwd_kernel', 0, 10)]
SPANS = [('converter/non_rigid', 0, 6), ('converter/non_rigid', 50, 54),
         ('converter/rigid', 6, 9), ('converter/rigid', 54, 57),
         ('converter/texture', 9, 10), ('converter/texture', 57, 59),
         ('sync/read', 20, 22), ('sync/read', 23, 24), ('sync/read', 25, 26),
         ('sync/read', 70, 76), ('update/converter', 30, 42),
         ('update/converter', 80, 88), ('densify/knn', 60, 69)]
# ms a frame or step (two of them), and a round (one)
WANT = {'nonrigid_ms.serve': 0.005, 'skinning_ms.serve': 0.003,
        'texture_ms.serve': 0.0015, 'syncs.serve': 2.0,
        'sync_wait_ms.serve': 0.005, 'sync_wait_ms.train': 0.005,
        'conv_update_ms.train': 0.010, 'knn_ms.train': 0.009}


def traced(spans):
    return trace.from_events(DEVICE, spans, 100e-6, 2, {}, {})


@pytest.mark.parametrize('metric', sorted(WANT))
def test_reads_its_span_a_frame_step_or_round(metric):
    assert registry.reader(metric)(traced(SPANS)) == \
        pytest.approx(WANT[metric])


@pytest.mark.parametrize('metric', sorted(WANT))
def test_is_none_where_its_span_did_not_run(metric):
    assert registry.reader(metric)(traced([('render/converter', 0, 9)])) \
        is None


def test_a_trace_0_run_leaves_the_tracer_off():
    from gsavatar_torch import tracing
    from perfbench.tests.tiny import run_tiny
    tracing.enable()
    tracing.disable()
    run_tiny('zju377_full.serve', seconds=0.5)
    assert not tracing.enabled() and tracing.records() == []
