"""K3 (`segsum_chunks` and its `segsum_carries` pass, every launch of the
step): the bound of its counted work over the device time in which either
ran in the traced steps (the union: the carries pass is launched with
programmatic dependent launch and overlaps the chunks), in %."""


def read(tr):
    return tr.roofline(('segsum_chunks', 'segsum_carries'), 'k3_ops',
                       'k3_bytes')
