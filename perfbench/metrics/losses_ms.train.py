"""The program's span `train/losses`, host ms a training step."""


def read(tr):
    return tr.per_unit_ms('train/losses')
