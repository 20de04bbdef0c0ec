"""The program's span `train/backward` (autograd through K2 and K3), host
ms a training step."""


def read(tr):
    return tr.per_unit_ms('train/backward')
