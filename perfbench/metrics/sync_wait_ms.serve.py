"""The host ms a frame spent in the program's reads of device tensors (the
spans `sync/read`), waiting for the device, in the traced frames."""


def read(tr):
    return tr.per_unit_ms('sync/read')
