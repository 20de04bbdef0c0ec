"""The program's span `train/update` (the converter's optimizer and the
arena Adam), host ms a training step."""


def read(tr):
    return tr.per_unit_ms('train/update')
