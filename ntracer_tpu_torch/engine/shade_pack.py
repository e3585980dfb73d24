"""The launch of the frame's post-walk glue kernel (``csrc/shade_pack.cu``,
``shade_pack_kernel<D>``), for ``wavefront.shade_pack``, which decides when
a frame takes it (``wavefront._glue_fused``) and holds its plain version.

The kernel runs one thread a ray from the primary walk's outputs to the
packed pixel bytes: the hit rows, the scene-box distance, the camera
light, the background and the device packer, each pixel written at its
linear place.  It launches on PyTorch's current stream with no sync, no
host read and no allocation of its own, so a frame captured as CUDA graphs
(``graphs``) records it inside its last segment; it is not a
``graphs.launch`` cut.  ``bytes_moved`` is what bounds it (the source's
note).
"""

from __future__ import annotations

import numpy as np
import torch

from . import resident_kernels as rk

# the dimensions the kernel is templated on
MIN_D, MAX_D = 3, 16
# runs of equal ray groups the kernel takes: a frame has at most 4 slabs
MAX_RUNS = 4
# mat_pack's columns: color, specular, opacity, reflectivity, specular
# intensity and exponent
MAT_W = 10


def on_card(dev):
    """Whether ``wavefront.shade_pack`` launches the kernel (CUDA tensors)
    or takes its plain version (CPU tensors); any other device raises."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"shade_pack runs on cuda or cpu, not {dev}")
    return dev.type == "cuda"


def launch(key, grid, rows, arrs, cfg, dyn, origin, dT, fmt_key, runs, w,
           tile_w, tile_h, then):
    """Launch the kernel on ``dT.device``'s current stream, then call
    ``then(error code)``; returns the (R // 4, bpp) int32 stream.

    ``key`` (R,) i32 is the walk's pool-local id (``grid``: ``rows`` is
    ``tri_pack``) or slot (``rows`` is ``res_slot_pack``), -1 on a miss;
    ``arrs`` gives ``tri_base``, the scene box and ``mat_pack``, ``cfg``
    the background axis, the camera light and the reflection depth,
    ``dyn`` the ambient and background colors; ``origin`` (d,) is the rays'
    one origin, ``dT`` (d, R) their directions; ``fmt_key`` the format
    (``packing.format_key``); ``runs`` the frame's groups
    (``wavefront._group_runs``) over rows ``w`` pixels wide, tiled in
    ``tile_w`` x ``tile_h`` pixels."""
    dev = dT.device
    d, R = dT.shape
    f32, i32 = torch.float32, torch.int32
    if not MIN_D <= d <= MAX_D:
        raise ValueError(f"the glue kernel takes {MIN_D} <= d <= {MAX_D}, "
                         f"not d={d}")
    if R % 4 or sum(c * n for _f, c, n, _s in runs) != R:
        raise ValueError(f"{R} rays are not the groups' {runs}")
    if len(runs) > MAX_RUNS:
        raise ValueError(f"the glue kernel takes at most {MAX_RUNS} runs "
                         f"of groups, not {len(runs)}")
    rk._check("dT", dT, f32, (d, R), dev)
    rk._check("origin", origin, f32, (d,), dev)
    rk._check("key", key, i32, (R,), dev)
    rk._check("rows", rows, f32, (rows.shape[0], d + 1 + (not grid)), dev)
    rk._check("tri_base", arrs["tri_base"], i32, (), dev)
    for name in ("bound_start", "bound_end"):
        rk._check(name, arrs[name], f32, (d,), dev)
    mat = arrs["mat_pack"]
    rk._check("mat_pack", mat, f32, (mat.shape[0], MAT_W), dev)
    for name in ("ambient", "bg1", "bg2", "bg3"):
        rk._check(name, dyn[name], f32, (3,), dev)
    from . import _build
    lib = _build.load()
    channels, bpp, reverse = fmt_key
    chan_int = np.array([(c[0], int(c[5])) for c in channels], np.int32)
    chan_f = np.array([c[1:5] for c in channels], np.float32)
    runs_a = np.array(runs, np.int32)
    out = torch.empty((R // 4, bpp), dtype=i32, device=dev)
    err = lib.ntr_shade_pack(
        key.data_ptr(), int(grid), rows.data_ptr(), rows.shape[1],
        rows.shape[0], arrs["tri_base"].data_ptr(), origin.data_ptr(),
        dT.data_ptr(), R, d, arrs["bound_start"].data_ptr(),
        arrs["bound_end"].data_ptr(), mat.data_ptr(), MAT_W,
        dyn["ambient"].data_ptr(), dyn["bg1"].data_ptr(),
        dyn["bg2"].data_ptr(), dyn["bg3"].data_ptr(), cfg.bg_axis,
        int(cfg.camera_light), cfg.max_reflect_depth,
        chan_int.ctypes.data, chan_f.ctypes.data, len(channels), bpp,
        int(reverse), runs_a.ctypes.data, len(runs), w, tile_w, tile_h,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    then(err)
    return out


def bytes_moved(d, R, bpp):
    """The least bytes the kernel moves for R rays at dimension d into
    bpp-byte pixels: each ray's key and direction read once and its pixel
    written once (the origin, the rows and the materials are a few kB that
    every ray shares)."""
    return R * (4 + 4 * d + bpp)
