"""The program's span `update/converter` (the converter's optimizer:
the clip's global norm and Adam over every leaf), host ms a training step
in the traced steps."""


def read(tr):
    return tr.per_unit_ms('update/converter')
