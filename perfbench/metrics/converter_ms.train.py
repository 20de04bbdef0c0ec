"""The program's span `render/converter`, host ms a training step."""


def read(tr):
    return tr.per_unit_ms('render/converter')
