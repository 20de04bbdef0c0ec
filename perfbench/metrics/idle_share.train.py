"""The share of the traced steps' wall time in which no operation ran on
the device, in %."""


def read(tr):
    return tr.idle_share()
