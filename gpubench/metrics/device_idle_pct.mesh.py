"""device_idle_pct.mesh: the share of the traced window in which no
kernel or copy ran on the card, in percent (the mesh cell's frames)."""

from gbench import readers


def read(run):
    return readers.device_idle_pct(run)
