"""The device's busy ms a training step in the traced slice."""


def read(tr):
    return 1e3 * tr.busy_s / tr.units
