"""Frames a second of one viewer, over the part of the traced run's window
after its traced slice (the untraced frames): what the serve cells' frame
tail moves with on a host-bound path."""


def read(tr):
    return tr.extra.get('rate')
