"""walk_ms.orth: device milliseconds a traced frame in the grid walk
kernel grid_nearest_kernel (csrc/grid_walk.cu: kernel 2.9 on the
10-orthoplex's two 512-triangle tiles), from the torch.profiler trace."""

from gbench import readers


def read(run):
    return readers.kernel_ms_per_frame(run, "grid_nearest_kernel")
