"""The program's span `non_rigid/pose_code` (the non-rigid field's
hierarchical pose encoder and latent, once a frame, inside
`converter/non_rigid`), host ms a frame in the traced frames."""


def read(tr):
    return tr.per_unit_ms('non_rigid/pose_code')
