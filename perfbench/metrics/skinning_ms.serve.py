"""The program's span `converter/rigid` (the skinning field and the
linear blend skinning), host ms a frame in the traced frames."""


def read(tr):
    return tr.per_unit_ms('converter/rigid')
