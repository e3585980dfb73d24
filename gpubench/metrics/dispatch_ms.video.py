"""dispatch_ms.video: host milliseconds a frame in
engine/wavefront.dispatch_packed over the window (the video cell's frames)."""

from gbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "dispatch")
