"""The program's span `non_rigid/mlp` (the MLP non-rigid field's
normalisation and conditional MLP on every Gaussian, inside
`converter/non_rigid`), host ms a frame in the traced frames."""


def read(tr):
    return tr.per_unit_ms('non_rigid/mlp')
