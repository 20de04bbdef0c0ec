"""The program's span `converter/non_rigid` (the hash-grid non-rigid
field), host ms a frame in the traced frames."""


def read(tr):
    return tr.per_unit_ms('converter/non_rigid')
