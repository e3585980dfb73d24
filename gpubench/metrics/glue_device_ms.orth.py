"""glue_device_ms.orth: device milliseconds a traced frame in every kernel
but the grid walk kernel grid_nearest_kernel: the d > 8 frame glue on the
card (rays, shared rows, pool exit, shading, the 16-bit packer), from the
torch.profiler trace.  Memory copies and sets (the pull's copy to the
host, the camera's upload) are left out."""

KERNEL = "grid_nearest_kernel"


def read(run):
    tr = run["traced"]
    if not tr:
        return None
    ms = [1e3 * (e - s) for n, s, e in tr["ops"]
          if KERNEL not in n and not n.startswith(("Memcpy", "Memset"))]
    return sum(ms) / tr["frames"] if ms else None
