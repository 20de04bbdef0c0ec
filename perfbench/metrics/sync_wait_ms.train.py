"""The host ms a training step spent in the program's reads of device
tensors (the spans `sync/read`: the pair count, the perceptual crop, the
largest rect side, the log's metrics), waiting for the device, in the
traced steps."""


def read(tr):
    return tr.per_unit_ms('sync/read')
