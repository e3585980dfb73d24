"""walk_ms.mesh: device milliseconds a traced frame in the walk kernel
nearest_stream_kernel (csrc/nearest_hit.cu on csrc/stream_walk.cuh: kernel
2.5 on the mesh, over the 48 MiB line), from the torch.profiler trace."""

from gbench import readers


def read(run):
    return readers.kernel_ms_per_frame(run, "nearest_stream_kernel")
