"""device_idle_pct.orth: the share of the traced window in which no
kernel or copy ran on the card, in percent (the orthoplex cell's
frames)."""

from gbench import readers


def read(run):
    return readers.device_idle_pct(run)
