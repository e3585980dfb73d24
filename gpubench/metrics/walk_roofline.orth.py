"""walk_roofline.orth: the grid walk's share of its roofline in the first traced frame of the orthoplex cell, in percent: the frozen bound of gbench/gridbound.py over the frame's grid_nearest_kernel time."""

from gbench import gridbound


def read(run):
    return gridbound.read(run)
