"""walk_ms.video: device milliseconds a traced frame in the walk kernel
nearest_stream_kernel (csrc/nearest_hit.cu on csrc/stream_walk.cuh: kernel
2.1 on the 120-cell's pool), from the torch.profiler trace."""

from gbench import readers


def read(run):
    return readers.kernel_ms_per_frame(run, "nearest_stream_kernel")
