"""The program's host reads of device tensors (`tracing.device_read`, each
a span `sync/read`) a frame in the traced frames: the pose step's three
and the pair count's one."""


def read(tr):
    calls = tr.span_calls.get('sync/read', 0)
    return calls / tr.units if calls else None
