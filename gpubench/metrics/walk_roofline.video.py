"""walk_roofline.video: the walk's share of its roofline in the first traced frame (the video cell's frames), in percent: the frozen bound of gbench/walkbound.py over the frame's nearest_stream_kernel time."""

from gbench import walkbound


def read(run):
    return walkbound.read(run)
