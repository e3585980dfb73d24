"""device_idle_pct.video: the share of the traced window in which no
kernel or copy ran on the card, in percent (the video cell's frames)."""

from gbench import readers


def read(run):
    return readers.device_idle_pct(run)
