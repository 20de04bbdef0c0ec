"""The program's span `converter/texture` (the colour decoder: the texture
MLP or the SH colours), host ms a frame in the traced frames."""


def read(tr):
    return tr.per_unit_ms('converter/texture')
