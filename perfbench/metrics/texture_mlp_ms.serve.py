"""The program's span `texture/mlp` (the colour MLP and its sigmoid on
every Gaussian, inside `converter/texture`), host ms a frame in the traced
frames."""


def read(tr):
    return tr.per_unit_ms('texture/mlp')
