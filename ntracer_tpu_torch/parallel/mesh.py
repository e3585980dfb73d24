"""Rendering over a 2-D mesh of devices: the counterpart of
``ntracer_tpu/parallel/mesh.py``.

Two independent axes, as in the JAX package:

  * ``px``   -- pixels: each row of the mesh renders its own slab of rays
               with the whole pool, and nothing crosses between rows until
               the frame is gathered;
  * ``prim`` -- the triangle pool: each device of a row holds one shard of
               the pool (whole 512-triangle chunks, pool ids kept global)
               with its own walk layouts, walks it for the row's rays, and
               the row's first device merges the shards' results
               (``wavefront._trace_shards``, ``_occlusion_shards``).

A ``Mesh`` is an (n_px, n_prim) array of ``torch.device``.  A list of
devices that repeats one device is accepted: the shards then run one after
another on it, which is how a mesh runs on one card or on the CPU (every
path of the sharding runs; no copy crosses between two devices).  On several
cards the work of each device is enqueued on its own current stream, and
torch orders each copy between two cards after the work enqueued before it
on both.

``make_mesh``, ``render_frame`` (float colors of a frame over any mesh) and
``get_packed_renderer`` (the renderers' px path: packed bytes, one slab a
device, ``dispatch_sharded``) are the entry points.  The device arrays of a
mesh are cached on the scene and dropped with its other device arrays when
its geometry changes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..engine import packing
from ..engine import resident_kernels as rk
from ..engine import wavefront
from ..engine.flatten import flatten_composite
from ..scene import BoxScene, CompositeScene
from ..engine.wavefront import CHUNK, TILE

# the pool rows a prim shard takes its slice of
_POOL_KEYS = ("tri_p1", "tri_fn", "tri_en", "tri_dc", "tri_mat", "tri_lo",
              "tri_hi", "cull_lo", "cull_hi")


class Mesh:
    """Devices in an (n_px, n_prim) grid: ``devices[i, j]`` holds prim
    shard j of px row i.  ``shape`` maps each axis name to its size."""

    axis_names = ("px", "prim")

    def __init__(self, devices):
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self):
        return (f"Mesh(px={self.shape['px']}, prim={self.shape['prim']}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def make_mesh(n_px: int, n_prim: int = 1, devices=None) -> Mesh:
    """An ``n_px`` x ``n_prim`` mesh of the first ``n_px * n_prim`` of
    ``devices`` (default: every card, ``wavefront.render_devices("cuda")``).
    Raises ValueError when there is no device, when there are too few, or
    when the list mixes device types; a list may repeat a device."""
    if devices is None:
        devices = wavefront.render_devices("cuda")
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh found no device (torch finds no CUDA "
                         "device; pass devices= to mesh other ones)")
    types = sorted({d.type for d in devices})
    if len(types) > 1:
        raise ValueError(f"a mesh takes devices of one type, not {types}")
    if n_px < 1 or n_prim < 1:
        raise ValueError(f"mesh {n_px}x{n_prim} has no device")
    if n_px * n_prim > len(devices):
        raise ValueError(f"mesh {n_px}x{n_prim} needs {n_px * n_prim} "
                         f"devices, have {len(devices)}")
    grid = np.empty((n_px, n_prim), dtype=object)
    for i, dev in enumerate(devices[:n_px * n_prim]):
        grid[divmod(i, n_prim)] = dev
    return Mesh(grid)


def _pad_pool(a, cfg, n_prim):
    """The pool rows ``a`` padded with zero rows (triangles that never
    hit) so that they split into ``n_prim`` shards of whole chunks:
    (rows, config with the padded ``n_tris``, rows a shard).  Shard ``s``
    holds pool rows ``[s * per, (s + 1) * per)``."""
    t = cfg.n_tris
    per = -(-t // (CHUNK * n_prim)) * CHUNK
    t_new = per * n_prim
    if t_new == t:
        return a, cfg, per
    out = dict(a)
    for k in _POOL_KEYS:
        v = np.asarray(a[k])
        out[k] = np.pad(v, [(0, t_new - t)] + [(0, 0)] * (v.ndim - 1))
    return out, dataclasses.replace(cfg, n_tris=t_new), per


def _shard_layouts(a, cfg, n_prim, per):
    """Host arrays of each prim shard's pool, built from its slice as
    ``wavefront.pool_arrays`` builds a whole pool, with ``tri_base`` the
    shard's first pool id (ids stay global) and ``shard_rows`` its rows.
    At d <= 8 the chunked layouts, all flagged as over the line (the
    K-slot walk's grouped rule) when the largest shard's is over
    ``rk.STREAM_POOL_BYTES`` (``mesh.py:115`` of the JAX package);
    at d > 8 the grid walks' layouts of an opaque pool or the chunk scan's
    arrays of a transparent one (the JAX package scans every prim-sharded
    pool of d > 8)."""
    scfg = dataclasses.replace(cfg, n_tris=per)
    slices = []
    for s in range(n_prim):
        sl = {k: np.asarray(a[k])[s * per:(s + 1) * per] for k in _POOL_KEYS}
        sl["mat_opacity"] = a["mat_opacity"]
        slices.append(sl)
    bins = [None] * n_prim
    streams = None
    if cfg.d <= rk.C_PAD:
        bins = [rk.centroid_bins(sl["cull_lo"], sl["cull_hi"],
                                 np.linalg.norm(sl["tri_fn"], axis=1), rk.CK)
                for sl in slices]
        largest = max(max(len(b) for b in bins), 1)
        streams = rk.pool_bytes(largest * rk.CK, cfg.d) > rk.STREAM_POOL_BYTES
    out = []
    for s, sl in enumerate(slices):
        arrs = wavefront.pool_arrays(sl, scfg, {}, bins=bins[s],
                                     streams=streams)
        arrs["tri_base"] = np.int32(s * per)
        out.append(arrs)
    return out


def _arrs_to(arrs, device):
    return {k: v.to(device) if torch.is_tensor(v) else v
            for k, v in arrs.items()}


def _mesh_arrays(scene, mesh):
    """The device arrays of each px row of ``mesh`` (cached on the scene
    until its next change): with one prim shard the scene's own arrays
    (``wavefront.get_device_scene``) on the row's device, else the scene's
    rows on the row's first device with ``shards``, each prim shard's
    arrays on its device (the scene's rows, ``sol_base`` the padded pool's
    size as in the JAX package, and the shard's pool).  A device that holds
    the same shard for several rows holds one copy.  Returns (rows, cfg):
    ``cfg`` the scene's configuration with its flags as they are now."""
    key = (tuple(str(d) for d in mesh.devices.flat),
           tuple(mesh.devices.shape))
    cache = getattr(scene, "_torch_mesh_cache", None)
    if cache is None or cache[0] != scene._version:
        cache = (scene._version, {})
        scene._torch_mesh_cache = cache
    built = cache[1]
    if key not in built:
        if mesh.shape["prim"] == 1:
            _cfg, arrs, flat = wavefront.get_device_scene(scene,
                                                          mesh.devices[0, 0])
            on = {str(arrs["mat_pack"].device): arrs}
            for dev in mesh.devices[:, 0]:
                if str(dev) not in on:
                    on[str(dev)] = _arrs_to(arrs, dev)
            rows = [on[str(dev)] for dev in mesh.devices[:, 0]]
        else:
            flat = flatten_composite(scene, chunk=CHUNK)
            rows = _shard_rows(flat, mesh)
        built[key] = (rows, flat.config)
    rows, cfg = built[key]
    return rows, wavefront.scene_config(scene, cfg)


def _shard_rows(flat, mesh):
    n_px, n_prim = mesh.devices.shape
    a, cfg, per = _pad_pool(flat.arrays, flat.config, n_prim)
    common = wavefront.scene_arrays(flat)
    if "sol_base" in common:
        common["sol_base"] = np.int32(cfg.n_tris)
    layouts = _shard_layouts(a, cfg, n_prim, per)
    on = {}
    rows = []
    for i in range(n_px):
        top = wavefront.tensors_from_arrays(common, mesh.devices[i, 0])
        top["shards"] = []
        for j in range(n_prim):
            dev = mesh.devices[i, j]
            if (str(dev), j) not in on:
                shard = wavefront.tensors_from_arrays(
                    {**common, **layouts[j]}, dev)
                shard["shard_rows"] = per
                on[str(dev), j] = shard
            top["shards"].append(on[str(dev), j])
        rows.append(top)
    return rows


def get_sharded_renderer(scene, mesh: Mesh, tile: int):
    """A renderer of ``tile`` rays over ``mesh``: ``(fn, rows)`` with
    ``fn(rows, scene, width, height, xs, ys) -> [tensor]``, for each px
    row i the (per, 3) float32 colors of the pixels ``xs``, ``ys`` (numpy,
    length ``tile``, a multiple of the px axis) ``[i * per, (i + 1) *
    per)`` (``per = tile // n_px``) on the row's device, not pulled.  A row
    traces its rays padded to whole 512-ray blocks with pixel (0, 0), as
    the strips are (``wavefront._tiled``); ``rows`` are the rows' device
    arrays, cached on the scene (``_mesh_arrays``): built once for a mesh
    and rebuilt when the scene changes, as its single-device arrays are
    (the JAX package's ``build_sharded_renderer`` and its cache)."""
    wavefront.check_scene(scene, CompositeScene)
    n_px = mesh.shape["px"]
    if tile % n_px:
        raise ValueError("tile size must divide evenly over the px axis")
    per = tile // n_px
    rows, _cfg = _mesh_arrays(scene, mesh)

    def fn(rows, scene, width, height, xs, ys):
        _rows, cfg = _mesh_arrays(scene, mesh)
        out = []
        for i, arrs in enumerate(rows):
            dev = mesh.devices[i, 0]
            sx = np.zeros(-(-per // rk.RAY_BLOCK) * rk.RAY_BLOCK, np.float32)
            sy = np.zeros_like(sx)
            sx[:per] = xs[i * per:(i + 1) * per]
            sy[:per] = ys[i * per:(i + 1) * per]
            with wavefront._on(dev):
                fov, cam_o, cam_t = wavefront._camera(scene, width, height,
                                                      dev)
                oT, dT = wavefront.make_rays(
                    cam_o, cam_t, *fov, *wavefront._to_device(dev, sx, sy))
                colorsT = wavefront._ray_colors_T(
                    arrs, cfg, wavefront._scene_dyn(scene, dev), oT, dT)
            out.append(colorsT[:, :per].T)
        return out

    return fn, rows


def _shard_groups(per_shard):
    """The ray groups of one px shard: (n_groups, rays a group), the split
    of ``wavefront._frame_groups`` (whole TILEs, at most MAX_GROUP_TILES a
    group) when the shard is whole TILEs, else one group."""
    if per_shard % TILE == 0:
        n_tiles = per_shard // TILE
        gt = min(n_tiles, wavefront.MAX_GROUP_TILES)
        while n_tiles % gt:
            gt -= 1
        return n_tiles // gt, gt * TILE
    return 1, per_shard


def build_packed_renderer(scene, mesh: Mesh, width, per_shard, key):
    """The renderers' frame over the px axis of ``mesh``: ``(fn, rows)``
    with ``fn(rows, scene, width, height, start) -> [tensor]``, one tensor a
    px row, on the row's device: the packed int32 stream of pixels ``[start
    + i * per_shard, start + (i + 1) * per_shard)`` of row i (with ``key``
    None the (per_shard, 3) float colors, packed on the host,
    ``wavefront._needs_host_pack``).  A row renders its groups
    (``_shard_groups``) from ``start + i * per_shard`` in the 32x16-pixel
    tile order where the shard's geometry allows it, in one pass
    (``wavefront._frame_packed_composite``), so its 512-ray blocks are the
    single frame's when ``per_shard`` is whole TILEs.  A mesh of several
    prim shards shards the pool of every row."""
    if per_shard % TILE and per_shard > TILE:
        raise ValueError("per_shard must be a multiple of TILE when tiled")
    rows, _cfg = _mesh_arrays(scene, mesh)
    n_groups, count = _shard_groups(per_shard)

    def fn(rows, scene, width, height, start=0):
        _rows, cfg = _mesh_arrays(scene, mesh)
        out = []
        for i, arrs in enumerate(rows):
            dev = mesh.devices[i, 0]
            base = start + i * per_shard
            groups = [(base + g * count, count) for g in range(n_groups)]
            with wavefront._on(dev):
                fov, cam_o, cam_t = wavefront._camera(scene, width, height,
                                                      dev)
                out.append(wavefront._frame_packed_composite(
                    arrs, cfg, wavefront._scene_dyn(scene, dev), cam_o,
                    cam_t, fov, groups, width, key))
        return out

    return fn, rows


def build_packed_box_renderer(scene, mesh: Mesh, width, per_shard, key):
    """BoxScene variant of ``build_packed_renderer`` (no device arrays:
    ``rows`` is None)."""
    n_groups, count = _shard_groups(per_shard)

    def fn(rows, scene, width, height, start=0):
        out = []
        for i in range(mesh.shape["px"]):
            dev = mesh.devices[i, 0]
            base = start + i * per_shard
            groups = [(base + g * count, count) for g in range(n_groups)]
            with wavefront._on(dev):
                fov, cam_o, cam_t = wavefront._camera(scene, width, height,
                                                      dev)
                out.append(wavefront._frame_packed_box(
                    scene.dimension, cam_o, cam_t, fov, groups, width, key))
        return out

    return fn, None


def get_packed_renderer(scene, mesh: Mesh, width, per_shard, key):
    """``build_packed_renderer`` (``build_packed_box_renderer`` for a
    BoxScene) with the mesh's device arrays cached on the scene."""
    wavefront.check_scene(scene, (CompositeScene, BoxScene))
    if isinstance(scene, CompositeScene):
        return build_packed_renderer(scene, mesh, width, per_shard, key)
    return build_packed_box_renderer(scene, mesh, width, per_shard, key)


def shard_pixels(total, n):
    """Pixels a px shard renders when a frame of ``total`` pixels is split
    over ``n`` devices: the JAX package's ``dispatch_packed`` split, whole
    512-ray blocks, whole TILEs past one TILE."""
    per = -(-total // n)
    per = -(-per // rk.RAY_BLOCK) * rk.RAY_BLOCK
    if per > TILE:
        per = -(-per // TILE) * TILE
    return per


def dispatch_sharded(scene, fmt, devices):
    """``wavefront.dispatch_packed`` over several devices: the frame's
    pixels split over a px mesh of ``devices`` (``shard_pixels``), one
    slab ``(start_px, tensor, ready)`` a device that holds pixels of the
    frame, ``ready`` an event on that device's current stream (None on the
    CPU)."""
    mesh = make_mesh(len(devices), 1, devices)
    total = fmt.width * fmt.height
    per = shard_pixels(total, len(devices))
    key = None if wavefront._needs_host_pack(fmt) \
        else packing.format_key(fmt)
    fn, rows = get_packed_renderer(scene, mesh, fmt.width, per, key)
    outs = fn(rows, scene, fmt.width, fmt.height)
    return [(i * per, out, wavefront._ready(out))
            for i, out in enumerate(outs) if i * per < total]


def render_frame(scene, fmt, mesh: Mesh):
    """Float colors of a full frame rendered over ``mesh``: (height, width,
    3) float32 numpy, the pixels in linear order split evenly over the px
    axis."""
    n_px = mesh.shape["px"]
    total = fmt.width * fmt.height
    tile = -(-total // n_px) * n_px
    fn, rows = get_sharded_renderer(scene, mesh, tile)
    xs, ys = wavefront._strip_coords(fmt.width, 0, fmt.height)
    xs = np.pad(xs, (0, tile - total))
    ys = np.pad(ys, (0, tile - total))
    out = np.concatenate([c.cpu().numpy()
                          for c in fn(rows, scene, fmt.width, fmt.height, xs,
                                      ys)])
    return out[:total].reshape(fmt.height, fmt.width, 3)
