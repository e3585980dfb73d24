"""PyTorch wavefront renderer: a whole frame of rays advances in lockstep.

The counterpart of ``ntracer_tpu/engine/wavefront.py`` for triangle and
solid ``CompositeScene``s (lights, shadows, reflections, transparent
materials) and for ``BoxScene``: rays are generated in 32x16-pixel tile
order, traced by the nearest-hit walk (``resident_kernels.nearest_hit``),
shaded -- with one occlusion walk (``resident_kernels.occluded``) per light
when the scene casts shadows -- bounced, packed to pixel bytes on the
device, and pulled into the caller's buffer.  A scene with a transparent
material takes the transparent walks instead (``nearest_hit_transparent``:
the nearest opaque hit and the K nearest transparent hits;
``occluded_transparent``: shadows filtered by the glass they cross) and
composes the K hits far to near over the opaque color.  A pool whose
layouts take more than ``rk.STREAM_POOL_BYTES`` (the JAX package's line)
takes the streaming variants of the same four walks (``*_hbm``), as the JAX
package does.  A scene of more than 8 dimensions (``d > rk.C_PAD``) has no
chunked layout: its opaque pool takes the grid walks of ``grid_kernels``
(``nearest_hit``, ``occluded``) over 512-triangle tiles in flatten order,
as the JAX package's Pallas grid kernels do, and its transparent pool the
chunk scan (``trace_scan``, ``occlusion_scan``: plain torch over the same
512-triangle chunks, the JAX package's XLA scan).  Solids (``CUBE``,
``SPHERE``) are tested after every walk, one by one (``_solid_test``).  The
rest of the frame is the same for every pool.  Function names follow the
JAX module so each has a visible counterpart.

Layouts stay lane-major as in the JAX package's transposed pipeline: rays
are (d, R), colors (3, R).  Every function takes tensors on one explicit
device; nothing falls back to another device.

A frame is one device pass whose output is cut into the JAX package's
slabs (``dispatch_packed``); ``pull_packed`` polls abort before each slab,
and on the card copies each on a copy stream of its own, so a frame's pull
overlaps the passes dispatched after it.  On one card a composite frame's
glue -- everything but the walks' launches -- is captured as CUDA graphs
and replayed, the walks launched eagerly between them (``graphs``).  A
format with an integer channel wider than 23 bits ships float colors,
packed on the host by the exact packer (``packing.pack_flat``).  An
opaque frame without point or global lights, solids or bounces runs its
glue after the primary walk -- hit rows, scene-box distance, camera light,
background, packer -- as one kernel (``shade_pack``).  Strips
(``render_strip_composite``, ``render_strip_box``) trace a band of rows in
linear pixel order.

Several devices (``parallel.mesh``): a renderer of the unindexed ``"cuda"``
splits a frame's pixels over every card (``render_devices``); a pool split
into prim shards (``arrs["shards"]``) is walked shard by shard, each on its
device, and merged on the rays' device (``_trace_shards``,
``_occlusion_shards``).  ``frame_stats`` counts a frame's rays, chunk
visits, shadow rays and live bounce rays as the JAX package does, and the
grid walks' tiles; without a ``stats`` dict the frame runs none of the
counting ops.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .. import tracing
from . import graphs
from . import grid_kernels as gk
from . import packing
from . import resident_kernels as rk
from . import shade_pack as sp
from .flatten import check_scene, flatten_composite, SceneConfig
from ..scene import BoxScene, CompositeScene

f32 = torch.float32
CHUNK = 512
TILE = 32768          # rays per dispatch group, as in the JAX package
MAX_GROUP_TILES = 64
TILE_W = 32
TILE_H = rk.RAY_BLOCK // TILE_W

REAL_MAX = float(np.finfo(np.float32).max)
INF = float("inf")
# rays of one chunk scan group (the JAX package scans a dispatch group):
# a chunk runs when a ray of the group may meet it
SCAN_RAYS = TILE
# point lights dimmer than this cast no shadow ray (tracer.hpp:31)
LIGHT_THRESHOLD = 1.0 / 512.0
ROUNDING_FUZZ = float(np.float32(np.finfo(np.float32).eps * 10))
# Diagnostic masks (frame_colors): a light this flat on a surface is grazing
# -- its shadow ray runs along the surface, and rounding decides whether the
# surface's own neighbours block it
GRAZING_SINE = 1e-5


def _stat(stats, key, count):
    """Add ``count()`` to the frame's counter ``key`` (the JAX package's
    ``_stat``).  Without a ``stats`` dict ``count`` is not called: a frame
    without counters runs none of their ops."""
    if stats is not None:
        stats[key] = stats.get(key, 0) + count()


# ---------------------------------------------------------------------------
# Small math helpers (sums run left to right, one rounding per op)
# ---------------------------------------------------------------------------

def _dotT(a, b):
    return rk._sum_rows(a * b)


def _unitT(v):
    return v / rk._sqrt(rk._sum_rows(v * v))[None]


def _pow(x, y):
    """float32 x**y taken in float64 and rounded: torch's float32 pow on the
    CPU differs between its vectorized and scalar paths, and which path an
    element takes depends on how the op is split across threads."""
    return torch.pow(x.double(), y.double()).to(torch.float32)


def _integer_pow(x, n):
    """x**n for a static integer n >= 1 by binary powering (the multiply
    sequence of ``lax.integer_pow``, which ``jnp.power`` uses for an integer
    exponent)."""
    acc = None
    while True:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if not n:
            return acc
        x = x * x


def _powf(x, y):
    """C ``powf`` semantics for negative bases: integral exponents give a
    signed result, non-integral ones NaN (the reference's Blinn-Phong pow
    sees negative half-vector dots, tracer.hpp:1703)."""
    p = _pow(torch.abs(x), y)
    y_int = torch.floor(y) == y
    odd = torch.remainder(y, 2.0) != 0
    neg = x < 0
    sign = torch.where(neg & y_int & odd, -1.0, 1.0)
    return torch.where(neg & ~y_int, float("nan"), sign * p)


# ---------------------------------------------------------------------------
# Ray generation
# ---------------------------------------------------------------------------

def make_rays(cam_origin, cam_t, fovI, half_w, half_h, xs, ys):
    """flat_origin_ray_source: dir = unit(fwd + right*fovI*(x-hw)
    - up*fovI*(y-hh)).  Returns (oT, dT), both (d, R)."""
    with tracing.span("dispatch.raygen"):
        right, up, fwd = cam_t[0], cam_t[1], cam_t[2]
        a = fovI * (xs - half_w)
        b = fovI * (ys - half_h)
        dT = (fwd[:, None] + right[:, None] * a[None, :]) \
            - up[:, None] * b[None, :]
        dT = _unitT(dT)
        oT = cam_origin[:, None].expand_as(dT).contiguous()
    return oT, dT


def _fov_params(w, h, fov):
    half_w = np.float32(w) / np.float32(2)
    half_h = np.float32(h) / np.float32(2)
    fovI = np.float32(np.tan(np.float32(fov) / np.float32(2)) / half_w)
    return float(fovI), float(half_w), float(half_h)


def _tile_order(w, count):
    """Whether a group of ``count`` rays over rows ``w`` pixels wide is
    ordered in TILE_W x TILE_H pixel tiles (``_ray_coords``)."""
    return w % TILE_W == 0 and count % w == 0 and (count // w) % TILE_H == 0


def _ray_coords(start, w, count, device):
    """Pixel coordinates of one ``count``-ray group starting at linear pixel
    ``start``.  When the frame allows it, rays are ordered in TILE_W x TILE_H
    pixel tiles so each 512-ray walk block covers a compact 2-D region.
    Returns (xs, ys, swz): ``swz`` (or None) permutes per-pixel values of the
    group back to linear pixel order."""
    j = torch.arange(count, dtype=torch.int64, device=device)
    if _tile_order(w, count):
        tpr = w // TILE_W
        tile = j // (TILE_W * TILE_H)
        within = j % (TILE_W * TILE_H)
        x = (tile % tpr) * TILE_W + within % TILE_W
        y = (tile // tpr) * TILE_H + within // TILE_W
        rows = count // w // TILE_H

        def unswz(v):
            # tile order is (ty, tx, wy, wx); linear order is (ty, wy, tx, wx)
            c = v.reshape(rows, tpr, TILE_H, TILE_W, *v.shape[1:])
            return c.transpose(1, 2).reshape(v.shape)

        return x.to(f32), (start // w + y).to(f32), unswz
    idx = start + j
    return (idx % w).to(f32), (idx // w).to(f32), None


def _frame_slabs(n_tiles):
    """(first tile, tiles) of every slab of a frame: the JAX package's split
    (``dispatch_packed``, ntracer_tpu/engine/wavefront.py:1666-1673) into at
    most 4 slabs, one for a frame of fewer than 8 tiles."""
    n_slabs = max(1, min(4, n_tiles // 4))
    per = -(-n_tiles // n_slabs)
    return [(s0, min(per, n_tiles - s0)) for s0 in range(0, n_tiles, per)]


def _frame_groups(n_tiles):
    """(start, count) of every ray group of a frame: the JAX package's slab
    split (``_frame_slabs``) and group split (at most MAX_GROUP_TILES
    tiles), so the port forms the same 512-ray blocks of the same pixels."""
    groups = []
    for s0, nt in _frame_slabs(n_tiles):
        gt = min(nt, MAX_GROUP_TILES)
        while nt % gt:
            gt -= 1
        count = gt * TILE
        groups += [(s0 * TILE + i * count, count) for i in range(nt // gt)]
    return groups


def _group_runs(groups, w):
    """``groups`` ((start, count) in ray order) as runs of equal groups:
    (first ray, rays a group, groups, whether they are tiled), the frame's
    layout as ``shade_pack``'s kernel takes it."""
    runs = []
    first = 0
    for _start, count in groups:
        if runs and runs[-1][1] == count:
            runs[-1][2] += 1
        else:
            runs.append([first, count, 1, int(_tile_order(w, count))])
        first += count
    return [tuple(r) for r in runs]


def _frame_coords(groups, w, device):
    """Concatenated coordinates of ``groups`` and the frame's unswizzle:
    a function taking per-ray values (R, ...) to linear pixel order."""
    xs, ys, swzs = [], [], []
    with tracing.span("dispatch.raygen"):
        for start, count in groups:
            x, y, swz = _ray_coords(start, w, count, device)
            xs.append(x)
            ys.append(y)
            swzs.append(swz)
        xs, ys = torch.cat(xs), torch.cat(ys)

    def unswizzle(v):
        parts = []
        off = 0
        for (_start, count), swz in zip(groups, swzs):
            part = v[off:off + count]
            parts.append(part if swz is None else swz(part))
            off += count
        return torch.cat(parts)

    return xs, ys, unswizzle


# ---------------------------------------------------------------------------
# Device scene
# ---------------------------------------------------------------------------

def tensors_from_arrays(arrs, device):
    """Device dict of numpy arrays (the JAX package's ``get_device_scene``
    layout, as numpy; ``res_opa`` with it when the scene has a transparent
    material) -> the port's tensors on ``device``.  ``res_neff``
    becomes a Python int: the walk's launch reads it on the host.  Added
    once per scene: ``res_base_boxes``, the chunk boxes in pool order as
    the walks take them (every occlusion and bounce walk goes in that
    order)."""
    out = {}
    for k, v in arrs.items():
        v = np.asarray(v)
        if k == "res_neff":
            out[k] = int(v.reshape(-1)[0])
        else:
            out[k] = torch.tensor(v, device=device)
    if "res_klo" in out:
        out["res_base_boxes"] = rk._order_boxes(
            dict(klo=out["res_klo"], khi=out["res_khi"]), out["res_order"],
            out["res_klo"].shape[1])
    return out


def device_arrays(flat):
    """Host (numpy) arrays of the device scene, named as in the JAX
    package's ``get_device_scene``: the scene's rows (``scene_arrays``) and
    its pool's layouts (``pool_arrays``)."""
    return pool_arrays(flat.arrays, flat.config, scene_arrays(flat))


def scene_arrays(flat):
    """The rows of the device scene that are not the pool's: materials
    ``mat_pack``, lights, bounds, ``tri_base`` (0: the pool's first id) and,
    for a scene with solids, their rows ``sol_*`` and ``sol_base``, the pool
    id of the first solid."""
    a = flat.arrays
    arrs = {k: a[k] for k in ("bound_start", "bound_end", "pl_pos",
                              "pl_color", "gl_dir", "gl_color")}
    if flat.config.n_solids:
        arrs.update({k: a[k] for k in ("sol_type", "sol_orient", "sol_inv",
                                       "sol_pos", "sol_mat")})
        arrs["sol_base"] = np.int32(flat.config.n_tris)
    arrs["mat_pack"] = np.concatenate([
        np.asarray(a["mat_color"], np.float32),
        np.asarray(a["mat_specular"], np.float32),
        np.asarray(a["mat_opacity"], np.float32)[:, None],
        np.asarray(a["mat_refl"], np.float32)[:, None],
        np.asarray(a["mat_spec_int"], np.float32)[:, None],
        np.asarray(a["mat_spec_exp"], np.float32)[:, None],
    ], axis=1)
    arrs["tri_base"] = np.int32(0)
    return arrs


def pool_arrays(a, cfg, arrs, bins=None, streams=None):
    """Add to ``arrs`` the layouts of the pool rows ``a`` (``cfg.n_tris``
    rows of ``tri_*`` and ``cull_*``; a prim shard's slice of the pool,
    see ``parallel.mesh``) and return it: the chunked pool layouts with
    their slot-indexed rows ``res_slot_pack`` = [fn(d), mat, pool id - the
    pool's ``tri_base``], for a scene with a transparent material the
    per-slot opacity row ``res_opa``, and for a pool over
    ``rk.STREAM_POOL_BYTES`` the flag ``res_is_hbm``: the walks then stream
    its chunks.  The port's walks have no chunk limit (the JAX package
    falls back to its XLA scan at 16,383 chunks).  ``bins`` are the pool's
    chunks (``rk.centroid_bins``) when the caller has them, ``streams``
    says whether the pool streams when the caller decides it.

    A scene of more than ``rk.C_PAD`` dimensions gets no chunked layout:
    its pool id-indexed rows ``tri_pack`` = [fn(d), mat] and, for an opaque
    pool, the grid walks' layouts ``kern_*``
    (``grid_kernels.prepare_tri_arrays``), for a transparent one the chunk
    scan's (``_scan_arrays``)."""
    d = cfg.d
    n_tris = cfg.n_tris
    if d > rk.C_PAD:
        if cfg.has_transparency:
            return _scan_arrays(a, d, n_tris, arrs)
        return _grid_arrays(a, d, n_tris, arrs)

    if bins is None:
        bins = rk.centroid_bins(a["cull_lo"], a["cull_hi"],
                                np.linalg.norm(a["tri_fn"], axis=1), rk.CK)
    if not bins:
        # no real triangle: one chunk of the first pool row, a padding
        # triangle, keeps every layout non-empty (its zero face normal
        # never hits, so every ray misses the pool)
        zero = np.zeros(d, np.float32)
        bins = [(zero, zero, [0])]
    res = rk.prepare_resident_cells(
        bins, a["tri_p1"], a["tri_fn"], a["tri_en"], a["tri_dc"],
        a["cull_lo"], a["cull_hi"], d, tri_mat=a["tri_mat"])
    # slot rows carry integer ids as float32 -- exact only below 2^24
    if res["ids"][:, 0, :].size >= 2 ** 24 or n_tris >= 2 ** 24:
        raise ValueError("res_slot_pack stores pool ids as float32, exact "
                         "only below 2^24 slots and triangles")
    sids = res["ids"][:, 0, :].reshape(-1).astype(np.int64)
    safe = np.clip(sids, 0, n_tris - 1)
    sp = np.empty((len(sids), d + 2), np.float32)
    sp[:, :d] = a["tri_fn"][safe]
    sp[:, d] = np.where(sids >= 0, a["tri_mat"][safe], 0)
    sp[:, d + 1] = np.where(sids >= 0, sids, -1)
    arrs["res_slot_pack"] = sp
    if cfg.has_transparency:
        tri_opacity = np.asarray(a["mat_opacity"], np.float32)[a["tri_mat"]]
        arrs["res_opa"] = rk.add_opacity(res, tri_opacity)["opa"]
    if streams is None:
        streams = rk.pool_bytes(len(bins) * rk.CK, d) > rk.STREAM_POOL_BYTES
    if streams:
        arrs["res_is_hbm"] = np.asarray([1], np.int32)
    arrs["res_gt"] = res["gt"]
    arrs["res_ci"] = res["ci"]
    arrs["res_ids"] = res["ids"]
    arrs["res_klo"] = res["klo"]
    arrs["res_khi"] = res["khi"]
    arrs["res_blo"] = res["b_lo"]
    arrs["res_bhi"] = res["b_hi"]
    arrs["res_order"] = res["base_order"]
    arrs["res_neff"] = res["n_eff"]
    return arrs


def _grid_arrays(a, d, n_tris, arrs):
    """``device_arrays`` of a scene with d > ``rk.C_PAD`` (the JAX
    package's ``get_device_scene`` for an opaque pool without a chunked
    layout): ``tri_pack`` and the grid walks' ``kern_*`` arrays."""
    _tri_pack(a, n_tris, arrs)
    kern = gk.prepare_tri_arrays(a["tri_p1"], a["tri_fn"], a["tri_en"],
                                 a["tri_dc"], a["cull_lo"], a["cull_hi"], d)
    for k, name in (("gt", "gt"), ("ci", "ci"), ("k_lo", "klo"),
                    ("k_hi", "khi"), ("k_any", "kany"), ("b_lo", "blo"),
                    ("b_hi", "bhi")):
        arrs["kern_" + name] = kern[k]
    # the plane rows as the CUDA grid walks read them
    arrs["kern_grec"] = gk.plane_records(torch.from_numpy(kern["gt"]),
                                         d).numpy()
    return arrs


def _tri_pack(a, n_tris, arrs):
    """The pool id-indexed rows ``tri_pack`` = [fn(d), mat]."""
    # pool ids and material ids are carried as float32: exact below 2^24
    if n_tris >= 2 ** 24:
        raise ValueError("tri_pack stores ids as float32, exact only below "
                         "2^24 triangles")
    arrs["tri_pack"] = np.concatenate([
        np.asarray(a["tri_fn"], np.float32),
        np.asarray(a["tri_mat"], np.float32)[:, None]], axis=1)


def _scan_arrays(a, d, n_tris, arrs):
    """``device_arrays`` of a transparent scene with d > ``rk.C_PAD`` (the
    JAX package's ``get_device_scene`` for a pool it traces with its XLA
    chunk scan): ``tri_pack``, the triangle rows, their opacity
    ``tri_opacity``, and the boxes ``ck_lo``/``ck_hi`` of the real
    triangles of every CHUNK-triangle chunk in flatten order, with
    ``ck_nonempty`` False for a chunk of padding only."""
    _tri_pack(a, n_tris, arrs)
    for k in ("tri_p1", "tri_fn", "tri_en", "tri_dc"):
        arrs[k] = a[k]
    arrs["tri_opacity"] = np.asarray(a["mat_opacity"],
                                     np.float32)[a["tri_mat"]]
    nc = n_tris // CHUNK
    lo = np.zeros((nc, d), np.float32)
    hi = np.zeros((nc, d), np.float32)
    nonempty = np.zeros((nc,), bool)
    fn_norms = np.linalg.norm(a["tri_fn"], axis=1)
    for c in range(nc):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        real = fn_norms[sl] > 0
        if real.any():
            lo[c] = a["cull_lo"][sl][real].min(axis=0)
            hi[c] = a["cull_hi"][sl][real].max(axis=0)
            nonempty[c] = True
    arrs.update(ck_lo=lo, ck_hi=hi, ck_nonempty=nonempty)
    return arrs


def get_device_scene(scene, device):
    """Flatten a CompositeScene and move its layouts to ``device``, cached
    on the scene as ``_torch_cache`` (keyed on ``scene._version`` and the
    device; ``"cuda"`` is the current card, so that it and its index share
    the arrays).  Render flags are re-read from the scene on every call."""
    check_scene(scene, CompositeScene)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (scene._version, str(device))
    cache = scene._torch_cache
    if cache is None or cache[0] != key:
        with tracing.span("scene.device", cached=False):
            with tracing.span("scene.flatten"):
                flat = flatten_composite(scene, chunk=CHUNK)
                host = device_arrays(flat)
            with tracing.span("scene.upload"):
                arrs = tensors_from_arrays(host, device)
        cache = (key, flat.config, arrs, flat)
        scene._torch_cache = cache
    _key, cfg, arrs, flat = cache
    return scene_config(scene, cfg), arrs, flat


def scene_config(scene, cfg):
    """``cfg`` with the render flags the scene has now."""
    return dataclasses.replace(
        cfg,
        shadows=bool(scene.shadows),
        camera_light=bool(scene.camera_light),
        max_reflect_depth=int(scene.max_reflect_depth),
        bg_axis=int(scene.bg_gradient_axis),
    )


def _to_device(device, *arrays):
    """Small float32 host arrays -> tensors on ``device``.  On the card in
    one copy from pinned memory that does not wait for the device: a plain
    host-to-device copy synchronizes the stream, so a frame's dispatch
    would wait for the frames dispatched before it."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    host = torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrays]))
    device = torch.device(device)
    if device.type == "cuda":
        host = host.pin_memory().to(device, non_blocking=True)
    out = []
    off = 0
    for a in arrays:
        out.append(host[off:off + a.size].view(a.shape))
        off += a.size
    return out


# the scene's colors a frame reads: ``_scene_dyn``'s keys
_DYN = ("ambient", "bg1", "bg2", "bg3")


def _scene_dyn(scene, device):
    with tracing.span("dispatch.camera"):
        return dict(zip(_DYN, _to_device(device, *(list(getattr(scene, k))
                                                    for k in _DYN))))


# ---------------------------------------------------------------------------
# Trace
# ---------------------------------------------------------------------------

def _res_dict(arrs):
    return dict(gt=arrs["res_gt"], ci=arrs["res_ci"], ids=arrs["res_ids"],
                klo=arrs["res_klo"], khi=arrs["res_khi"],
                b_lo=arrs["res_blo"], b_hi=arrs["res_bhi"],
                n_eff=arrs["res_neff"], base_order=arrs["res_order"],
                base_boxes=arrs.get("res_base_boxes"),
                opa=arrs.get("res_opa"))


def _kern_dict(arrs):
    kern = dict(gt=arrs["kern_gt"], ci=arrs["kern_ci"],
                k_lo=arrs["kern_klo"], k_hi=arrs["kern_khi"],
                k_any=arrs["kern_kany"], b_lo=arrs["kern_blo"],
                b_hi=arrs["kern_bhi"])
    if "kern_grec" in arrs:
        kern["grec"] = arrs["kern_grec"]
    return kern


def _streams(arrs):
    """Whether the scene's pool is over the line: its walks stream."""
    return "res_is_hbm" in arrs


def _grid(arrs):
    """Whether the scene's pool takes the grid walks (d > 8, opaque)."""
    return "kern_gt" in arrs


def _scan(arrs):
    """Whether the scene's pool takes the chunk scan (d > 8, transparent):
    it has no layout for a walk, only the scan's chunk boxes ``ck_*``."""
    return "res_gt" not in arrs and not _grid(arrs)


def primary_ctx(arrs, cfg, origin):
    """Per-frame context of the shared-origin (primary) trace: the
    front-to-back chunk order and the hoisted origin-dot rows; for the
    grid walks (d > 8) the hoisted rows alone (``sh_kern``); nothing for
    the chunk scan; for a pool split into prim shards each shard's, on its
    device (``shards``)."""
    with tracing.span("dispatch.primary_ctx"):
        return _primary_ctx(arrs, cfg, origin)


def _primary_ctx(arrs, cfg, origin):
    if "shards" in arrs:
        ctx = []
        for _j, sarrs, scfg, sdev in _shard_parts(arrs, cfg):
            with _on(sdev):
                ctx.append(_primary_ctx(sarrs, scfg, origin.to(sdev)))
        return {"shards": ctx}
    if _grid(arrs):
        return {"sh_kern": gk.shared_rows(arrs["kern_gt"], arrs["kern_ci"],
                                          origin, cfg.d)}
    if _scan(arrs):
        return {}
    res = _res_dict(arrs)
    order, dmin = rk.chunk_order(res["klo"], res["khi"], origin)
    return {"order": order, "dmin": dmin,
            "sh_res": rk.shared_rows_res(res["gt"], res["ci"], origin,
                                         cfg.d)}


# ---------------------------------------------------------------------------
# Solids
# ---------------------------------------------------------------------------

def _matvecT(m, vT):
    """(d, R) columns ``m @ v`` -- the JAX package's ``v @ m.T`` -- each
    sum taken left to right, the same on every device."""
    return rk._sum_rows((m[:, :, None] * vT[None]).transpose(0, 1))


def _solid_test(arrs, s, oT, dT, d):
    """Solid ``s`` against (d, R) rays (tracer.hpp:251-276; cube 126-152,
    sphere 154-173): the ray enters the solid's frame by its inverse
    orientation; the cube is hit at the first axis in order whose near
    face is met within 1 + ROUNDING_FUZZ, the sphere at the smaller root.
    Returns t (R,), point and normal (d, R) in the scene's frame; t = inf
    on a miss.  The cube's normal is the orientation's image of its axis,
    not re-unitized, as in the reference."""
    inv = arrs["sol_inv"][s]
    orient = arrs["sol_orient"][s]
    pos = arrs["sol_pos"][s]
    to = _matvecT(inv, oT) - pos[:, None]
    td = _matvecT(inv, dT)

    R = oT.shape[1]
    cube_t = torch.full((R,), INF, dtype=f32, device=oT.device)
    cube_n = torch.zeros_like(to)
    found = torch.zeros((R,), dtype=torch.bool, device=oT.device)
    for i in range(d):
        ni = torch.where(td[i] < 0, 1.0, -1.0)
        dist = (ni - to[i]) / td[i]
        ok = (td[i] != 0) & (dist > 0)
        p = to + dist[None, :] * td
        for j in range(d):
            if j != i:
                ok = ok & (torch.abs(p[j]) <= 1 + ROUNDING_FUZZ)
        take = ok & ~found
        cube_t = torch.where(take, dist, cube_t)
        n_axis = torch.zeros_like(to)
        n_axis[i] = ni
        cube_n = torch.where(take[None, :], n_axis, cube_n)
        found = found | ok

    a = _dotT(td, td)
    b = 2 * _dotT(td, to)
    c = _dotT(to, to) - 1
    disc = b * b - 4 * a * c
    sph_t = (-b - rk._sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
    sph_t = torch.where((disc >= 0) & (sph_t > 0), sph_t, INF)

    is_cube = arrs["sol_type"][s] == 1
    t = torch.where(is_cube, cube_t, sph_t)
    p_obj = to + t[None, :] * td
    n_obj = torch.where(is_cube, cube_n, p_obj)
    return (t, _matvecT(orient, p_obj + pos[:, None]),
            _matvecT(orient, n_obj))


def _solid_opacity(arrs, s):
    # a one-element index: indexing by a 0-d tensor reads it on the host
    return arrs["mat_pack"][arrs["sol_mat"][s:s + 1].long(), 6][0]


# ---------------------------------------------------------------------------
# Trace
# ---------------------------------------------------------------------------

def _slot_rows(arrs, cfg, key):
    """Face normals (d, K, R), materials and pool ids (K, R) of the K slot
    keys ``key``: a walk's keys are slots of ``res_slot_pack``, the chunk
    scan's pool ids (``tri_pack``'s rows from ``tri_base``); -1 for
    none."""
    d = cfg.d
    if _scan(arrs):
        rows = arrs["tri_pack"][torch.clamp(
            key - arrs["tri_base"], 0, cfg.n_tris - 1).long()] \
            .permute(2, 0, 1)                               # (d + 1, K, R)
        return rows[:d], rows[d].to(torch.int32), key
    rows = arrs["res_slot_pack"][torch.clamp(key, min=0).long()] \
        .permute(2, 0, 1)                                   # (d + 2, K, R)
    tid = torch.where(key >= 0,
                      rows[d + 1].to(torch.int32) + arrs["tri_base"], -1)
    return rows[:d], rows[d].to(torch.int32), tid


def _trace_finish_T(arrs, cfg, oT, dT, skip, res, K, solids=True):
    """Solids and the K-slot payload, the (k, R) finish of a trace (the
    JAX package's ``_trace_finish_T``, and at d > 8 its row
    ``_trace_finish`` and ``_hit_geometry``: the same float32 operations).

    Each solid in turn takes the opaque hit where it is nearer (t, pid,
    pointT, normalT, mat), and with K transparent slots (``ttT`` sorted
    ascending by t, ``tkeyT`` their keys, see ``_slot_rows``) a glass solid
    enters them by a stable sort of the slots with the solid's hit
    appended last, keeping the first K: as in the JAX package, a slot tied
    with the solid keeps its place.  Then the slots' view-facing normals
    ``tnormT`` (d, K, R), materials ``tmatT`` and pool ids ``tidT`` (K, R)
    come from the slot rows, or from the solid's test for a solid's slot;
    ``tidT`` is not trimmed yet (``_trace_close``).  A prim shard other than
    the first (``solids`` False) tests no solid: the first one's finish
    counts each solid once."""
    d = cfg.d
    R = oT.shape[1]
    dev = oT.device
    solids = [_solid_test(arrs, s, oT, dT, d)
              for s in range(cfg.n_solids if solids else 0)]
    if K:
        key = res.pop("tkeyT")
        # the solid in a slot, -1 for a triangle's or an empty slot
        tsol = torch.full_like(key, -1)
    for s, (st, sp, sn) in enumerate(solids):
        sid = arrs["sol_base"] + s
        s_opaque = _solid_opacity(arrs, s) >= 1
        svalid = (st > 0) & (skip != sid)
        so_valid = svalid & s_opaque & (st < res["t"])
        res["t"] = torch.where(so_valid, st, res["t"])
        res["pid"] = torch.where(so_valid, sid, res["pid"])
        res["pointT"] = torch.where(so_valid[None, :], sp, res["pointT"])
        res["normalT"] = torch.where(so_valid[None, :], sn, res["normalT"])
        res["mat"] = torch.where(so_valid, arrs["sol_mat"][s], res["mat"])
        if K:
            tins = torch.where(svalid & ~s_opaque, st, INF)
            allt = torch.cat([res["ttT"], tins[None, :]])
            order = torch.argsort(allt, dim=0, stable=True)[:K]
            res["ttT"] = torch.gather(allt, 0, order)
            key = torch.gather(torch.cat([key, torch.full(
                (1, R), -1, dtype=key.dtype, device=dev)]), 0, order)
            tsol = torch.gather(torch.cat([tsol, torch.full(
                (1, R), s, dtype=tsol.dtype, device=dev)]), 0, order)
    if K:
        fnk, tmat, tid = _slot_rows(arrs, cfg, key)
        denomk = _dotT(fnk, dT[:, None, :])
        tnorm = _unitT(fnk) * torch.where(denomk > 0, -1.0, 1.0)[None, :, :]
        for s, (st, sp, sn) in enumerate(solids):
            sel = tsol == s
            tnorm = torch.where(sel[None, :, :], sn[:, None, :], tnorm)
            tmat = torch.where(sel, arrs["sol_mat"][s], tmat)
            tid = torch.where(sel, arrs["sol_base"] + s, tid)
        res["tnormT"] = tnorm
        res["tmatT"] = tmat
        res["tidT"] = tid
    return res


def _trace_close(res, K):
    """The end of a trace, after the prim shards' merge when there are
    shards: ``hit``, and the trim -- a slot counts only in front of the
    opaque hit (a slot of one shard may lie behind another's hit)."""
    res["hit"] = res["pid"] >= 0
    if K:
        tvalid = (res["tidT"] >= 0) & (res["ttT"] < res["t"][None, :])
        res["tidT"] = torch.where(tvalid, res["tidT"], -1)
    return res


def _local_skip(arrs, skip):
    """The pool-local id of the surface each ray leaves, as the walks take
    it.  On a prim shard an id of another shard becomes -1 ("no skip"):
    shifted by the shard's ``tri_base`` it could fall on -1 or on the
    padding slots' id -2, or past the shard's rows."""
    local = skip - arrs["tri_base"]
    if "shard_rows" in arrs:
        local = torch.where((local >= 0) & (local < arrs["shard_rows"]),
                            local, -1)
    return local


def trace_pool(arrs, cfg: SceneConfig, oT, dT, skip, shared_origin=None,
               active=None, pctx=None, stats=None, depth=0):
    """Nearest opaque hit of (d, R) rays over the triangle pool and the
    solids and, for a scene with a transparent material, the K =
    ``cfg.max_transparent_hits`` nearest transparent hits in front of it.

    ``shared_origin`` (d,) selects the front-to-back order and shared rows of
    primary rays (``pctx`` from primary_ctx, computed here when absent);
    ``active`` masks bounce rays out.  Returns t, pid, mat (R,) and pointT,
    normalT (d, R); with K also ttT, tidT, tmatT (K, R) and tnormT
    (d, K, R), slots sorted ascending by t, ``tidT`` -1 where empty.
    ``stats`` (a dict, or None) accumulates the counters ``rays_traced``
    and ``chunks_visited`` (the grid walk: ``grid_tiles_visited``);
    ``depth``, the bounce the rays serve, labels the walk's span
    (``dispatch.walk``).

    A pool of d > 8 takes the grid walk, or with a transparent material the
    chunk scan, and gathers its hit rows by pool id from ``tri_pack``; as in
    the JAX package's grid branch the grid walk traces every ray, the bounce
    loop's dead ones too (``active`` does not reach it: their results are
    masked downstream).  A pool sharded over devices (``arrs["shards"]``,
    see ``parallel.mesh``) is traced shard by shard and the shards' results
    merged (``_trace_shards``)."""
    K = cfg.max_transparent_hits if cfg.has_transparency else 0
    if shared_origin is not None and pctx is None:
        pctx = primary_ctx(arrs, cfg, shared_origin)
    shared = shared_origin is not None
    if "shards" in arrs:
        res = _trace_shards(arrs, cfg, oT, dT, skip, shared, active, pctx, K,
                            depth)
    else:
        res = _trace_walk(arrs, cfg, oT, dT, skip, shared, active, pctx, K,
                          stats, depth)
        res = _trace_finish_T(arrs, cfg, oT, dT, skip, res, K)
    return _trace_close(res, K)


def _trace_walk(arrs, cfg, oT, dT, skip, shared, active, pctx, K, stats,
                depth=0):
    """The pool's walk (or chunk scan) and its hit rows: t, pid, mat,
    pointT, normalT and, with K, the slots ``ttT`` and their keys
    ``tkeyT``, for ``_trace_finish_T``."""
    return _hit_rows(arrs, cfg, oT, dT, _walk(arrs, cfg, oT, dT, skip, shared,
                                              active, pctx, K, stats, depth))


def _walk(arrs, cfg, oT, dT, skip, shared, active, pctx, K, stats,
          depth=0):
    """The pool's walk (or chunk scan) as it returns: ``kt`` and ``kid``
    (the grid walk: pool-local ids, -1 on a miss), ``kt`` and ``slot`` (the
    chunk walks: slots of ``res_slot_pack``, -1 on a miss) or ``t`` and
    ``pid`` (the chunk scan), and with K the slots ``ttT`` and their keys
    ``tkeyT``.  The walk's call is the span ``dispatch.walk``, its
    attribute ``walk`` the kind: ``"stream"`` (the chunk walks, kernels
    2.1-2.8), ``"grid"`` (2.9) or ``"scan"``."""
    d = cfg.d
    R = oT.shape[1]
    skip_local = _local_skip(arrs, skip)
    if _grid(arrs):
        with graphs.walk_span("dispatch.walk", depth=depth, walk="grid"):
            kt, kid, tiles = gk.nearest_hit(
                _kern_dict(arrs), oT, dT, skip_local, d,
                sh=pctx["sh_kern"] if shared else None)
        # the JAX package's grid branch counts rays only; the tiles the
        # blocks ran are the port's own counter
        _stat(stats, "rays_traced", lambda: R)
        _stat(stats, "grid_tiles_visited", tiles.sum)
        return dict(kt=kt, kid=kid)
    if _scan(arrs):
        with graphs.walk_span("dispatch.walk", depth=depth, walk="scan"):
            t, pid, ttT, tidT, vis = trace_scan(arrs, cfg, oT, dT, skip,
                                                active=active)
        _stat(stats, "chunks_visited", vis.sum)
        _stat(stats, "rays_traced",
              lambda: R if active is None else active.sum())
        walk = dict(t=t, pid=pid)
        if K:
            walk.update(ttT=ttT, tkeyT=tidT)
        return walk
    res_k = _res_dict(arrs)
    order, sh = (pctx["order"], pctx["sh_res"]) if shared else (None, None)
    walk = {}
    if K:
        nearest_t = rk.nearest_hit_transparent_hbm if _streams(arrs) \
            else rk.nearest_hit_transparent
        with graphs.walk_span("dispatch.walk", depth=depth, walk="stream"):
            kt, slot, ktt, ktslot, vis = nearest_t(
                res_k, oT, dT, skip_local, d, K, order=order,
                active=active, sh=sh)
        # stable, as jnp.argsort is: exactly tied surfaces keep slot order
        order_k = torch.argsort(ktt, dim=0, stable=True)
        walk["ttT"] = torch.gather(ktt, 0, order_k)
        walk["tkeyT"] = torch.gather(ktslot, 0, order_k)
    else:
        nearest = rk.nearest_hit_hbm if _streams(arrs) else rk.nearest_hit
        with graphs.walk_span("dispatch.walk", depth=depth, walk="stream"):
            kt, slot, vis = nearest(res_k, oT, dT, skip_local, d,
                                    order=order, active=active, sh=sh)
    _stat(stats, "rays_traced",
          lambda: R if active is None else active.sum())
    _stat(stats, "chunks_visited", vis.sum)
    walk.update(kt=kt, slot=slot)
    return walk


def _hit_rows(arrs, cfg, oT, dT, walk):
    """t, pid, mat, pointT and the view-facing unit normal normalT of the
    hits ``_walk`` returned, with its K slots as they are."""
    d = cfg.d
    res = {k: walk[k] for k in ("ttT", "tkeyT") if k in walk}
    if "slot" in walk:
        slot = walk["slot"]
        rowT = arrs["res_slot_pack"][torch.clamp(slot, min=0).long()].T
        t = torch.where(slot >= 0, walk["kt"], REAL_MAX)
        pid = torch.where(slot >= 0,
                          rowT[d + 1].to(torch.int32) + arrs["tri_base"], -1)
    else:
        if "kid" in walk:
            kid = walk["kid"]
            t = torch.where(kid >= 0, walk["kt"], REAL_MAX)
            pid = torch.where(kid >= 0, kid + arrs["tri_base"], -1)
        else:
            t, pid = walk["t"], walk["pid"]
        rowT = arrs["tri_pack"][torch.clamp(pid - arrs["tri_base"], 0,
                                            cfg.n_tris - 1).long()].T
    pointT = oT + t[None, :] * dT
    fnT = rowT[:d]
    denom = _dotT(fnT, dT)
    normalT = _unitT(fnT) * torch.where(denom > 0, -1.0, 1.0)[None, :]
    res.update(t=t, pid=pid, pointT=pointT, normalT=normalT,
               mat=rowT[d].to(torch.int32))
    return res


# ---------------------------------------------------------------------------
# Prim shards: a pool split over devices
# ---------------------------------------------------------------------------

def _on(device):
    """The context in which work for ``device`` is enqueued: on a card that
    card's (a C entry launches on the current device, on its current
    stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _shard_parts(arrs, cfg):
    """(index, shard dict, shard config, device) of each prim shard of
    ``arrs``: a shard's config counts its own pool rows."""
    for j, sarrs in enumerate(arrs["shards"]):
        yield (j, sarrs, dataclasses.replace(cfg, n_tris=sarrs["shard_rows"]),
               sarrs["mat_pack"].device)


def _to(device, *tensors):
    """``tensors`` on ``device`` (None stays None).  A copy between two
    cards is ordered after the work enqueued on both devices' current
    streams, as torch orders every copy across devices."""
    return [None if x is None else x.to(device) for x in tensors]


def _trace_shards(arrs, cfg, oT, dT, skip, shared, active, pctx, K,
                  depth=0):
    """``trace_pool`` over a pool split into prim shards: each shard runs
    its walk and its finish (the solids on the first shard only, and the
    K-slot rows) on its own device, and the results come back to the rays'
    device and are merged there in shard order, as the JAX package merges
    them (``_trace_finish_T``'s all_gather): the nearest hit of the first
    shard of the least t (``torch.argmin`` takes the first minimum, as
    ``jnp.argmin`` does), the K slots by a stable sort of [shard 0's K, shard
    1's K, ...], keeping K.  The trim follows in ``_trace_close``."""
    dev = oT.device
    parts = []
    for j, sarrs, scfg, sdev in _shard_parts(arrs, cfg):
        with _on(sdev):
            soT, sdT, sskip, sactive = _to(sdev, oT, dT, skip, active)
            res = _trace_walk(sarrs, scfg, soT, sdT, sskip, shared, sactive,
                              pctx["shards"][j] if shared else None, K, None,
                              depth)
            res = _trace_finish_T(sarrs, scfg, soT, sdT, sskip, res, K,
                                  solids=j == 0)
        parts.append(dict(zip(res, _to(dev, *res.values()))))
    winner = torch.argmin(torch.stack([p["t"] for p in parts]), dim=0)
    out = {}
    for k in ("t", "pid", "mat", "pointT", "normalT"):
        v = torch.stack([p[k] for p in parts])
        idx = winner[None].expand(1, *v.shape[1:]) if v.dim() == 2 \
            else winner[None, None].expand(1, *v.shape[1:])
        out[k] = torch.gather(v, 0, idx)[0]
    if K:
        allt = torch.cat([p["ttT"] for p in parts])          # (P * K, R)
        order = torch.argsort(allt, dim=0, stable=True)[:K]
        out["ttT"] = torch.gather(allt, 0, order)
        for k in ("tidT", "tmatT"):
            out[k] = torch.gather(torch.cat([p[k] for p in parts]), 0, order)
        tnorm = torch.cat([p["tnormT"] for p in parts], dim=1)
        out["tnormT"] = torch.gather(
            tnorm, 1, order[None].expand(tnorm.shape[0], -1, -1))
    return out


# ---------------------------------------------------------------------------
# Chunk scan (transparent pools of d > 8)
# ---------------------------------------------------------------------------

def _chunk_planes(p1, fn, en):
    """Face and edge plane normals of a chunk: (C, d), (C, d), (C, d-1, d)
    -> (C, d, d), ``planes[:, 0]`` the face normal, ``planes[:, 1:]`` the
    edge normals."""
    return torch.cat([fn[:, None, :], en], dim=1)


def _tri_chunk_test(oT, dT, p1, fn, en, dc, d):
    """(d, R) rays against a chunk of C triangles (tracer.hpp:411-440 /
    551-599) -> t, valid, denom, each (C, R).

    The 2d plane dots of every pair come from products with contraction d,
    one (C, R) slab a plane: (C, d) @ (d, R).  They are taken in float64
    and rounded once, the same on every device and never in TF32 (the JAX
    package's ``dot_general`` at ``Precision.HIGHEST`` sums in float32:
    ulps apart)."""
    planes = _chunk_planes(p1, fn, en)                       # (C, d, d)
    planes64, o64, d64 = planes.double(), oT.double(), dT.double()

    def dots(i):
        """Plane i's dots with the origins and the directions."""
        return ((planes64[:, i] @ o64).to(f32),
                (planes64[:, i] @ d64).to(f32))

    o0, denom = dots(0)
    t = -(o0 + dc[:, None]) / denom
    valid = (denom != 0) & (t > 0)
    # edge areas a_i = e_i.p1 - e_i.o - t * e_i.dir, one (C, R) slab each
    ci = rk._sum_rows((planes[:, 1:, :] * p1[:, None, :]).permute(2, 0, 1))
    tot = torch.zeros_like(t)
    for i in range(1, d):
        oi, di = dots(i)
        a = ci[:, i - 1:i] - oi - t * di
        valid = valid & (a >= -ROUNDING_FUZZ) & (a <= 1 + ROUNDING_FUZZ)
        tot = tot + a
    valid = valid & (tot <= 1 + ROUNDING_FUZZ)
    return t, valid, denom


def _chunk_arrays(arrs, cfg):
    """The pool as (chunks, CHUNK, ...) rows, with the chunk boxes."""
    d = cfg.d
    nc = cfg.n_tris // CHUNK
    return dict(
        p1=arrs["tri_p1"].reshape(nc, CHUNK, d),
        fn=arrs["tri_fn"].reshape(nc, CHUNK, d),
        en=arrs["tri_en"].reshape(nc, CHUNK, max(d - 1, 1), d),
        dc=arrs["tri_dc"].reshape(nc, CHUNK),
        opacity=arrs["tri_opacity"].reshape(nc, CHUNK),
        lo=arrs["ck_lo"],
        hi=arrs["ck_hi"],
        nonempty=arrs["ck_nonempty"].tolist(),
    )


def _slab_entry(oT, dT, lo, hi):
    """Conservative ray/box entry distance of (d, R) rays: (R,), inf when
    the box is missed.  NaN-safe for zero direction components."""
    big = float(np.float32(3e37))
    inv = torch.where(dT != 0, 1.0 / torch.where(dT != 0, dT, 1.0), 0.0)
    a = (lo[:, None] - oT) * inv
    b = (hi[:, None] - oT) * inv
    par = dT == 0
    inside = (oT >= lo[:, None]) & (oT <= hi[:, None])
    t0 = torch.where(par, torch.where(inside, -big, big), torch.minimum(a, b))
    t1 = torch.where(par, torch.where(inside, big, -big), torch.maximum(a, b))
    tn = torch.amax(t0, dim=0)
    tf = torch.amin(t1, dim=0)
    entry = torch.clamp(tn, min=0.0)
    hit = (tf >= entry) & (tf >= 0)
    return torch.where(hit, entry, INF)


def _chunk_k_nearest(tm, K):
    """The K smallest of each column of ``tm`` (C, R) -- positive distances,
    inf where none -- ties to the lowest row, as ``lax.top_k`` breaks them:
    (distances, rows), each (K, R), ascending.  The float's bits order
    non-negative floats, so (bits, row) is one integer key a column, every
    key distinct."""
    C = tm.shape[0]
    rows = torch.arange(C, dtype=torch.int64, device=tm.device)
    keys = tm.view(torch.int32).to(torch.int64) * C + rows[:, None]
    low = torch.topk(keys, K, dim=0, largest=False, sorted=True).values
    return (torch.div(low, C, rounding_mode="floor").to(torch.int32)
            .view(torch.float32), low % C)


def trace_scan(arrs, cfg: SceneConfig, oT, dT, skip, active=None):
    """The JAX package's XLA chunk scan (``trace_pool``'s scan branch) in
    plain torch: (d, R) rays against the pool's CHUNK-triangle chunks in
    flatten order, in groups of ``SCAN_RAYS`` rays.  A chunk runs for a
    group when it holds a real triangle and some ray of the group enters its
    box before that ray's nearest hit so far; it then takes the nearest
    opaque hit (strict ``<``, the lowest triangle of a tie) and the chunk's
    K nearest glass hits (``_chunk_k_nearest``), merged with the carried K
    by a stable sort, carry first.  The chunk tests every active ray of the
    group, as the JAX package does: a ray whose hit lies on the chunk box's
    boundary, rounded out of it, still finds it when the group runs the
    chunk.  Rays of ``active`` False start at t = 0 and are not tested (the
    JAX package tests them and trims their slots).

    Returns t (R,) (REAL_MAX without a hit), pid (R,), ttT and tidT (K, R)
    (sorted, inf and -1 where empty; untrimmed; None when the pool is
    opaque) and the visits, the chunks run by each group (n_groups,)."""
    K = cfg.max_transparent_hits if cfg.has_transparency else 0
    d = cfg.d
    dev = oT.device
    ck = _chunk_arrays(arrs, cfg)
    R = oT.shape[1]
    t = torch.full((R,), REAL_MAX, dtype=f32, device=dev)
    if active is not None:
        t = torch.where(active, t, 0.0)
    pid = torch.full((R,), -1, dtype=torch.int32, device=dev)
    tt = torch.full((K, R), INF, dtype=f32, device=dev)
    tid = torch.full((K, R), -1, dtype=torch.int32, device=dev)
    visits = []
    for g0 in range(0, R, SCAN_RAYS):
        g = slice(g0, min(R, g0 + SCAN_RAYS))
        run = torch.nonzero(t[g] > 0).squeeze(1) + g0
        nvis = 0
        for c, nonempty in enumerate(ck["nonempty"]):
            entry = _slab_entry(oT[:, g], dT[:, g], ck["lo"][c], ck["hi"][c])
            if not (nonempty and bool((entry < t[g]).any())):
                continue
            nvis += 1
            tc, valid, _ = _tri_chunk_test(oT[:, run], dT[:, run],
                                           ck["p1"][c], ck["fn"][c],
                                           ck["en"][c], ck["dc"][c], d)
            ids = arrs["tri_base"] + c * CHUNK + torch.arange(
                CHUNK, dtype=torch.int32, device=dev)
            valid = valid & (ids[:, None] != skip[run][None, :])
            opaque = (ck["opacity"][c] >= 1)[:, None]
            tm = torch.where(valid & opaque, tc, INF)
            ct = torch.amin(tm, dim=0)
            upd = ct < t[run]
            t[run] = torch.where(upd, ct, t[run])
            pid[run] = torch.where(upd, ids[torch.argmin(tm, dim=0)],
                                   pid[run])
            if K:
                ctt, cargs = _chunk_k_nearest(
                    torch.where(valid & ~opaque, tc, INF), K)
                allt = torch.cat([tt[:, run], ctt])
                alli = torch.cat([tid[:, run], ids[cargs]])
                order = torch.argsort(allt, dim=0, stable=True)[:K]
                tt[:, run] = torch.gather(allt, 0, order)
                tid[:, run] = torch.gather(alli, 0, order)
        visits.append(nvis)
    return (t, pid, tt if K else None, tid if K else None,
            torch.tensor(visits, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------

def background_T(cfg, dyn, dT):
    """Background gradient (tracer.hpp:1866-1867): (d, R) -> (3, R)."""
    intensity = dT[cfg.bg_axis]
    pos = (dyn["bg1"][:, None] * intensity[None, :]
           + dyn["bg2"][:, None] * (1 - intensity)[None, :])
    neg = (dyn["bg3"][:, None] * (-intensity)[None, :]
           + dyn["bg2"][:, None] * (1 + intensity)[None, :])
    return torch.where((intensity >= 0)[None, :], pos, neg)


def aabb_distance_T(cfg, arrs, oT, dT):
    """tracer.hpp:1892-1918: the first axis in order whose boundary plane is
    hit within bounds; -1 when the scene box is missed.  -> (R,)."""
    d = cfg.d
    bs, be = arrs["bound_start"], arrs["bound_end"]
    R = oT.shape[1]
    result = torch.full((R,), -1.0, dtype=f32, device=oT.device)
    found = torch.zeros((R,), dtype=torch.bool, device=oT.device)
    for i in range(d):
        oo = torch.where(dT[i] > 0, bs[i], be[i])
        dist = (oo - oT[i]) / dT[i]
        neg = dist < 0
        dist_eff = torch.where(neg, 0.0, dist)
        ok = dT[i] != 0
        for j in range(d):
            v = dT[j] * dist_eff + oT[j]
            inside = (v < be[j]) & (v > bs[j])
            # when dist was clamped to 0, axis i is checked too
            ok = ok & (~neg | inside) if j == i else ok & inside
        take = ok & ~found
        result = torch.where(take, dist_eff, result)
        found = found | ok
    return result


def occlusion(arrs, cfg: SceneConfig, oT, dT, ldist, skip, clamp_exit=True,
              stats=None):
    """Shadow query (light_reaches, tracer.hpp:1750-1766, with true any-hit
    semantics): is there an opaque hit with 0 < t < ``ldist`` along each
    (d, R) ray, and how much light do the transparent hits in that range let
    through?  -> (blocked (R,) bool, filt): ``filt`` (R,) f32 is the product
    of (1 - opacity) over those hits (meaningful where not ``blocked``);
    None in a scene without a transparent material (nothing filters, and
    the caller skips the multiply).

    Rays with ``ldist <= 0`` are inactive; the walk skips ray blocks without
    an active ray, so a wholly inactive batch costs one short launch and no
    host sync.  ``clamp_exit`` cuts ``ldist`` to the ray's exit from the
    pool's box, which bounds a global light's infinite distance (no pool hit
    lies beyond it); point-light queries arrive finite and skip it.  The
    grid walk and the chunk scan (d > 8) take ``ldist`` unclamped, as the
    JAX package's grid kernel and scan branches do, and the solids always
    do.  ``skip`` is the pool id of the surface the ray leaves.  ``stats``
    (a dict, or None) accumulates ``shadow_rays`` and
    ``occl_chunks_visited`` as the JAX package counts them (its grid branch
    counts neither; the port's grid walk counts ``occl_grid_tiles_visited``
    instead).  A pool split into prim shards is queried shard by shard
    (``_occlusion_shards``)."""
    if "shards" in arrs:
        return _occlusion_shards(arrs, cfg, oT, dT, ldist, skip, clamp_exit)
    blocked, filt = _occlusion_walk(arrs, cfg, oT, dT, ldist, skip,
                                    clamp_exit, stats)
    return _occlusion_finish(arrs, cfg, oT, dT, ldist, skip, blocked, filt)


def _occlusion_walk(arrs, cfg, oT, dT, ldist, skip, clamp_exit, stats):
    """The pool's part of a shadow query: (blocked, filt) of its walk or
    chunk scan, without the solids.  The walk's call is the span
    ``dispatch.occlusion``, its attribute ``walk`` the kind as in
    ``_trace_walk`` (``"grid"``: 2.10)."""
    skip_local = _local_skip(arrs, skip)
    if _grid(arrs):
        with graphs.walk_span("dispatch.occlusion", walk="grid"):
            blocked, tiles = gk.occluded(_kern_dict(arrs), oT, dT, ldist,
                                         skip_local, cfg.d)
        _stat(stats, "occl_grid_tiles_visited", tiles.sum)
        return blocked, None
    if _scan(arrs):
        with graphs.walk_span("dispatch.occlusion", walk="scan"):
            blocked, filt, vis = occlusion_scan(arrs, cfg, oT, dT, ldist,
                                                skip)
        _stat(stats, "shadow_rays", lambda: (ldist > 0).sum())
        _stat(stats, "occl_chunks_visited", vis.sum)
        return blocked, filt
    res_k = _res_dict(arrs)
    pool_ldist = torch.minimum(ldist, rk._scene_exit_T(
        oT, dT, res_k["b_lo"], res_k["b_hi"])) if clamp_exit else ldist
    if cfg.has_transparency:
        occ_t = rk.occluded_transparent_hbm if _streams(arrs) \
            else rk.occluded_transparent
        with graphs.walk_span("dispatch.occlusion", walk="stream"):
            blocked, filt, vis = occ_t(res_k, oT, dT, pool_ldist, skip_local,
                                       cfg.d)
    else:
        occ = rk.occluded_hbm if _streams(arrs) else rk.occluded
        with graphs.walk_span("dispatch.occlusion", walk="stream"):
            blocked, vis = occ(res_k, oT, dT, pool_ldist, skip_local, cfg.d)
        filt = None
    _stat(stats, "shadow_rays", lambda: (pool_ldist > 0).sum())
    _stat(stats, "occl_chunks_visited", vis.sum)
    return blocked, filt


def _occlusion_shards(arrs, cfg, oT, dT, ldist, skip, clamp_exit):
    """``occlusion`` over a pool split into prim shards: each shard queries
    its pool (and the first one the solids) on its own device, and the
    results are merged on the rays' device as the JAX package merges them
    (``_occlusion_finish``): ``blocked`` ORed, ``filt`` multiplied in shard
    order, left to right, the order in which XLA reduces its all_gather's
    product on the CPU."""
    dev = oT.device
    blocked = filt = None
    for j, sarrs, scfg, sdev in _shard_parts(arrs, cfg):
        with _on(sdev):
            soT, sdT, sldist, sskip = _to(sdev, oT, dT, ldist, skip)
            b, f = _occlusion_walk(sarrs, scfg, soT, sdT, sldist, sskip,
                                   clamp_exit, None)
            b, f = _occlusion_finish(sarrs, scfg, soT, sdT, sldist, sskip, b,
                                     f, solids=j == 0)
        b, f = _to(dev, b, f)
        blocked = b if blocked is None else blocked | b
        if f is not None:
            filt = f if filt is None else filt * f
    return blocked, filt


def occlusion_scan(arrs, cfg: SceneConfig, oT, dT, ldist, skip):
    """The JAX package's XLA chunk scan for shadow rays (``occlusion``'s
    scan branch) in plain torch, in groups of ``SCAN_RAYS`` rays: a chunk
    runs for a group when it holds a real triangle and some unblocked ray of
    the group enters its box before ``ldist``; its opaque hits before
    ``ldist`` block, its glass hits multiply ``filt`` by their (1 -
    opacity).  It tests the group's unblocked rays of ``ldist`` > 0 (see
    ``trace_scan``): the others cannot change, but for a blocked ray's
    ``filt``, which the JAX package goes on multiplying.  Returns blocked,
    filt (R,) (None when the pool is opaque) and the chunks run by each
    group (n_groups,)."""
    d = cfg.d
    dev = oT.device
    ck = _chunk_arrays(arrs, cfg)
    R = oT.shape[1]
    blocked = torch.zeros((R,), dtype=torch.bool, device=dev)
    filt = torch.ones((R,), dtype=f32, device=dev)
    visits = []
    for g0 in range(0, R, SCAN_RAYS):
        g = slice(g0, min(R, g0 + SCAN_RAYS))
        nvis = 0
        for c, nonempty in enumerate(ck["nonempty"]):
            entry = _slab_entry(oT[:, g], dT[:, g], ck["lo"][c], ck["hi"][c])
            if not (nonempty and
                    bool(((entry < ldist[g]) & ~blocked[g]).any())):
                continue
            nvis += 1
            run = torch.nonzero((ldist[g] > 0) & ~blocked[g]).squeeze(1) + g0
            tc, valid, _ = _tri_chunk_test(oT[:, run], dT[:, run],
                                           ck["p1"][c], ck["fn"][c],
                                           ck["en"][c], ck["dc"][c], d)
            ids = arrs["tri_base"] + c * CHUNK + torch.arange(
                CHUNK, dtype=torch.int32, device=dev)
            valid = valid & (ids[:, None] != skip[run][None, :]) \
                & (tc < ldist[run][None, :])
            opacity = ck["opacity"][c][:, None]
            blocked[run] = blocked[run] | torch.any(valid & (opacity >= 1),
                                                    dim=0)
            if cfg.has_transparency:
                filt[run] = filt[run] * torch.prod(torch.where(
                    valid & (opacity < 1), 1 - opacity, 1.0), dim=0)
        visits.append(nvis)
    return (blocked, filt if cfg.has_transparency else None,
            torch.tensor(visits, dtype=torch.int32))


def _occlusion_finish(arrs, cfg, oT, dT, ldist, skip, blocked, filt,
                      solids=True):
    """The solids of a shadow query, tested against the unclamped
    ``ldist``: an opaque one blocks, a glass one multiplies ``filt``.  A
    prim shard other than the first (``solids`` False) tests none."""
    for s in range(cfg.n_solids if solids else 0):
        st, _sp, _sn = _solid_test(arrs, s, oT, dT, cfg.d)
        svalid = (st > 0) & (st < ldist) & (skip != arrs["sol_base"] + s)
        s_op = _solid_opacity(arrs, s)
        blocked = blocked | (svalid & (s_op >= 1))
        if filt is not None:
            filt = filt * torch.where(svalid & (s_op < 1), 1 - s_op, 1.0)
    return blocked, filt


def _note(masks, name, rays):
    """OR ``rays`` (R,) bool into the frame's diagnostic mask ``name``."""
    if masks is not None:
        masks[name] = rays | masks[name] if name in masks else rays


def shade_local_T(arrs, cfg: SceneConfig, dT, pointT, normalT, pid, mi, depth,
                  dyn, active=None, masks=None, stats=None):
    """Local shading (tracer.hpp:1768-1854): (d, R) geometry -> (3, R)
    color, (3, R) child coefficient, (d, R) child direction.  With
    ``cfg.shadows`` every light casts one occlusion query from the hit
    points (skipping the surface ``pid`` they lie on), for the rays in
    ``active`` that face the light.  ``masks`` (a dict, see
    ``frame_colors``) gathers what the queries found, ``stats`` (see
    ``frame_stats``) counts them."""
    R = dT.shape[1]
    dev = dT.device
    rowT = arrs["mat_pack"][mi.long()].T
    mc = rowT[0:3]
    mspec = rowT[3:6]
    refl = rowT[7]
    spec_int = rowT[8]
    spec_exp = rowT[9]

    light = torch.zeros((3, R), dtype=f32, device=dev)
    specular = torch.zeros((3, R), dtype=f32, device=dev)
    spec_a = torch.zeros((R,), dtype=f32, device=dev)

    def note_query(want, blocked, filt, sine):
        _note(masks, "shadowed", want & blocked)
        _note(masks, "grazing", want & (sine < GRAZING_SINE))
        if filt is not None:
            _note(masks, "filtered", want & ~blocked & (filt < 1))

    def add_specular(specular, spec_a, filteredT, light_dirT, mask):
        """Blinn-Phong highlight of one light (tracer.hpp:1701-1707)."""
        mask = mask & (spec_int != 0)
        h = _unitT(light_dirT - dT)
        base = _powf(_dotT(normalT, h), spec_exp) * spec_int
        new_s = specular + mspec * filteredT * (base * (1 - spec_a))[None, :]
        new_a = spec_a + base * (1 - spec_a)
        new_s = new_s * new_a[None, :]
        return (torch.where(mask[None, :], new_s, specular),
                torch.where(mask, new_a, spec_a))

    for li in range(cfg.n_point_lights):
        plp = arrs["pl_pos"][li]
        plc = arrs["pl_color"][li]
        lv = pointT - plp[:, None]
        dist = rk._sqrt(_dotT(lv, lv))
        lv = lv / dist[None, :]
        sine = _dotT(normalT, lv)
        strength = 1.0 / _integer_pow(dist, cfg.d - 1)
        if cfg.shadows:
            want = (sine > 0) & (torch.amax(plc) * strength * sine
                                 > LIGHT_THRESHOLD)
            if active is not None:
                want = want & active
            blocked, filt = occlusion(arrs, cfg, pointT, lv,
                                      torch.where(want, dist, 0.0), pid,
                                      clamp_exit=False, stats=stats)
            note_query(want, blocked, filt, sine)
            ok = want & ~blocked
            filteredT = plc[:, None] if filt is None \
                else plc[:, None] * filt[None, :]
            filteredT = filteredT * strength[None, :]
            light = light + torch.where(ok[None, :],
                                        filteredT * sine[None, :], 0.0)
            specular, spec_a = add_specular(specular, spec_a, filteredT, lv,
                                            ok)
        else:
            contrib = plc[:, None] * (strength * sine)[None, :]
            light = light + torch.where((sine > 0)[None, :], contrib, 0.0)

    for gi in range(cfg.n_global_lights):
        gld = arrs["gl_dir"][gi]
        glc = arrs["gl_color"][gi]
        sine = -_dotT(normalT, gld[:, None])
        if cfg.shadows:
            want = sine > 0
            if active is not None:
                want = want & active
            ldT = (-gld)[:, None].expand_as(pointT).contiguous()
            blocked, filt = occlusion(arrs, cfg, pointT, ldT,
                                      torch.where(want, REAL_MAX, 0.0), pid,
                                      stats=stats)
            note_query(want, blocked, filt, sine)
            ok = want & ~blocked
            filteredT = glc[:, None] if filt is None \
                else glc[:, None] * filt[None, :]
            light = light + torch.where(ok[None, :],
                                        filteredT * sine[None, :], 0.0)
            specular, spec_a = add_specular(specular, spec_a, filteredT, ldT,
                                            ok)
        else:
            light = light + torch.where((sine > 0)[None, :],
                                        glc[:, None] * sine[None, :], 0.0)

    sine = -_dotT(dT, normalT)
    if cfg.camera_light:
        cl = torch.clamp(sine, min=0.0)
        light = light + cl[None, :]
        mask = (sine > 0) & (spec_int != 0)
        base = _pow(torch.clamp(sine, min=0.0), spec_exp) * spec_int
        new_s = specular + mspec * (base * (1 - spec_a))[None, :]
        new_a = spec_a + base * (1 - spec_a)
        new_s = new_s * new_a[None, :]
        specular = torch.where(mask[None, :], new_s, specular)
        spec_a = torch.where(mask, new_a, spec_a)

    r0 = dyn["ambient"][:, None] + mc * light

    refl_on = (refl != 0) & (depth < cfg.max_reflect_depth)
    refl_eff = torch.where(refl_on, refl, 0.0)
    local = specular + ((1 - spec_a) * (1 - refl_eff))[None, :] * r0
    child_coef = ((1 - spec_a) * refl_eff)[None, :] * mc
    child_dir = dT - normalT * (-2 * sine)[None, :]
    return local, child_coef, child_dir


# ---------------------------------------------------------------------------
# Bounce loop
# ---------------------------------------------------------------------------

def _primary_masks(res):
    """Diagnostic masks of a primary trace ``res``, (R,) bool each: ``hit``
    (an opaque surface), ``layered`` (a valid transparent slot) and ``full``
    (every slot valid: the ray may cross more glass than it keeps)."""
    masks = dict(hit=res["hit"])
    if "tidT" in res:
        valid = res["tidT"] >= 0
        masks.update(layered=valid[0], full=valid.all(dim=0))
    return masks


def _ray_colors_T(arrs, cfg: SceneConfig, dyn, oT, dT, pctx=None, masks=None,
                  stats=None):
    """Color of (d, R) rays (ray_color, tracer.hpp:1856-1883) with
    reflections unrolled into a weighted bounce loop: bounce rays trace
    with an active mask and skip the surface they leave.  -> (3, R) rows,
    ready for the channel packer (the JAX package's
    ``ray_colors_packable`` on its transposed pipeline).  A dict passed as
    ``masks`` is filled with the frame's diagnostic masks (see
    ``frame_colors``), one passed as ``stats`` with its counters (see
    ``frame_stats``)."""
    R = oT.shape[1]
    dev = oT.device
    out = torch.zeros((3, R), dtype=f32, device=dev)
    weight = torch.ones((3, R), dtype=f32, device=dev)
    active = torch.ones((R,), dtype=torch.bool, device=dev)
    skip = torch.full((R,), -1, dtype=torch.int32, device=dev)
    max_bounces = _max_bounces(cfg)

    for depth in range(max_bounces + 1):
        if depth:
            _bounce_stats(stats, depth, active)
        res = trace_pool(arrs, cfg, oT, dT, skip,
                         shared_origin=oT[:, 0] if depth == 0 else None,
                         active=None if depth == 0 else active,
                         pctx=pctx if depth == 0 else None, stats=stats,
                         depth=depth)
        if masks is not None and depth == 0:
            masks.update(_primary_masks(res))
        with tracing.span("dispatch.shade", depth=depth):
            dist = aabb_distance_T(cfg, arrs, oT, dT)
            hit = res["hit"] & (dist >= 0)
            live = hit if depth == 0 else hit & active
            localT, child_coefT, child_dirT = shade_local_T(
                arrs, cfg, dT, res["pointT"], res["normalT"], res["pid"],
                res["mat"], depth, dyn, active=live, masks=masks,
                stats=stats)
            bgT = background_T(cfg, dyn, dT)
            color_hereT = torch.where(hit[None, :], localT, bgT)
            weight_scale = None
            if cfg.has_transparency:
                color_hereT, weight_scale = _compose_transparent_T(
                    arrs, cfg, dyn, oT, dT, res, color_hereT, depth,
                    masks=masks, stats=stats)
            out = out + torch.where(active[None, :], weight * color_hereT,
                                    0.0)
            if depth == max_bounces:
                break
            weight = weight * child_coefT
            if weight_scale is not None:
                weight = weight * weight_scale[None, :]
            active = active & hit & torch.any(child_coefT > 0, dim=0)
            oT = res["pointT"]
            dT = _unitT(child_dirT)
            skip = res["pid"]
    return out


def _max_bounces(cfg):
    """The bounces the frame's loop runs past its primary rays."""
    return cfg.max_reflect_depth if cfg.has_reflectivity else 0


def _bounce_stats(stats, depth, active):
    """The JAX package's bounce counters: the live rays at ``depth`` and
    the ray blocks of ``min(RAY_BLOCK, R)`` rays with a live ray (one
    block when R is not a multiple of it)."""
    R = active.shape[0]
    rb = min(rk.RAY_BLOCK, R)
    _stat(stats, f"bounce_live_rays_d{depth}", active.sum)
    _stat(stats, f"bounce_live_blocks_d{depth}",
          lambda: active.reshape(R // rb, rb).any(dim=1).sum()
          if R % rb == 0 else 1)


def _compose_transparent_T(arrs, cfg, dyn, oT, dT, res, base_colorT, depth,
                           masks=None, stats=None):
    """Far-to-near composition (tracer.hpp:1870-1880) of the K transparent
    hits of ``res`` over (3, R) color rows: every valid slot is shaded like
    a surface (its own shadow queries included) and laid over what is behind
    it by its material's opacity.  Returns (color, transmission): the bounce
    loop scales the opaque hit's child weight by the light all the slots
    let through."""
    R = oT.shape[1]
    color = base_colorT
    trans = torch.ones((R,), dtype=f32, device=oT.device)
    for k in range(cfg.max_transparent_hits - 1, -1, -1):
        tid = res["tidT"][k]
        valid = tid >= 0
        pointT = oT + res["ttT"][k][None, :] * dT
        mi = res["tmatT"][k]
        localT, _coef, _dir = shade_local_T(
            arrs, cfg, dT, pointT, res["tnormT"][:, k],
            torch.where(valid, tid, 0), mi, depth, dyn, active=valid,
            masks=masks, stats=stats)
        op = arrs["mat_pack"][mi.long(), 6]
        new = localT * op[None, :] + color * (1 - op)[None, :]
        color = torch.where(valid[None, :], new, color)
        trans = torch.where(valid, trans * (1 - op), trans)
    return color, trans


# ---------------------------------------------------------------------------
# The post-walk glue as one kernel
# ---------------------------------------------------------------------------

def _glue_fused(arrs, cfg, key):
    """Whether a frame's post-walk glue runs as one kernel (``shade_pack``),
    from what the frame is: an opaque pool not split into prim shards,
    without solids, point or global lights or bounces, 3 <= d <= 16, packed
    on the device (``key`` given, no integer channel over 23 bits).  The
    caller adds its own part: one device, no ``masks``.  Every other frame
    runs the chain (``_ray_colors_T``, ``packing.pack_device_stream``)."""
    return (key is not None and "shards" not in arrs
            and not cfg.has_transparency and not cfg.n_solids
            and not cfg.n_point_lights and not cfg.n_global_lights
            and not _max_bounces(cfg) and sp.MIN_D <= cfg.d <= sp.MAX_D
            and all(tfloat or bits <= 23
                    for bits, *_f, tfloat in key[0]))


def shade_pack(arrs, cfg, dyn, origin, dT, walk, key, groups, w, unswz):
    """The post-walk glue of a frame that ``_glue_fused`` takes -- the hit
    rows, the scene-box distance, the camera light, the background and the
    device packer -- on the primary rays of the one ``origin`` (d,) in the
    directions ``dT`` (d, R), ``walk`` their nearest-hit walk's output
    (``_walk``).  Returns the packed int32 stream (R // 4, bpp) in linear
    pixel order, as ``packing.pack_device_stream`` gives it: the rays are
    in the order of ``groups`` over rows ``w`` pixels wide, ``unswz`` the
    frame's unswizzle (``_frame_coords``).  On CUDA tensors the CUDA kernel
    runs (``csrc/shade_pack.cu``, which computes each pixel's place from
    ``groups`` and ``w``; ``shade_pack.launches`` counts it), on CPU
    tensors its plain version ``_shade_pack_ref``."""
    if not sp.on_card(dT.device):
        return _shade_pack_ref(arrs, cfg, dyn, origin, dT, walk, key, unswz)
    grid = "kid" in walk
    return sp.launch(
        walk["kid" if grid else "slot"], grid,
        arrs["tri_pack" if grid else "res_slot_pack"], arrs, cfg, dyn,
        origin, dT, key, _group_runs(groups, w), w, TILE_W, TILE_H,
        rk._counted("shade_pack", shade_pack))


shade_pack.launches = 0


def _shade_pack_ref(arrs, cfg, dyn, origin, dT, walk, key, unswz):
    """``shade_pack``'s plain version: the chain it replaces, from
    ``_trace_walk``'s hit rows through the bounce loop's one step
    (``_ray_colors_T``) to ``packing.pack_device_stream``."""
    oT = origin[:, None].expand_as(dT).contiguous()
    res = _trace_close(_hit_rows(arrs, cfg, oT, dT, walk), 0)
    hit = res["hit"] & (aabb_distance_T(cfg, arrs, oT, dT) >= 0)
    localT, _coef, _dir = shade_local_T(
        arrs, cfg, dT, res["pointT"], res["normalT"], res["pid"], res["mat"],
        0, dyn, active=hit)
    colorT = torch.where(hit[None, :], localT, background_T(cfg, dyn, dT))
    # the bounce loop's one step: out = 0 + weight * color, weight 1
    colorT = torch.zeros_like(colorT) + torch.ones_like(colorT) * colorT
    return packing.pack_device_stream(colorT, key, permute=unswz)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def _box_colors(d, cam_origin, cam_t, fov_params, xs, ys):
    """BoxScene pixels (tracer.hpp:101-114): the unit hypercube at the
    origin.  -> (3, R)."""
    oT, dT = make_rays(cam_origin, cam_t, *fov_params, xs, ys)
    R = dT.shape[1]
    found = torch.zeros((R,), dtype=torch.bool, device=dT.device)
    normalT = torch.zeros_like(dT)
    for i in range(d):
        ni = torch.where(dT[i] < 0, 1.0, -1.0)
        dist = (ni - oT[i]) / dT[i]
        ok = (dT[i] != 0) & (dist > 0)
        p = oT + dist[None, :] * dT
        for j in range(d):
            if j != i:
                ok = ok & (torch.abs(p[j]) <= 1 + ROUNDING_FUZZ)
        take = ok & ~found
        n_axis = torch.zeros_like(dT)
        n_axis[i] = ni
        normalT = torch.where(take[None, :], n_axis, normalT)
        found = found | ok

    sine = _dotT(dT, normalT)
    v = torch.where(sine <= 0, -sine, 0.0)
    hit_color = torch.stack([v, v * 0.5, v * 0.5])
    intensity = dT[0]
    zero = torch.zeros_like(intensity)
    miss_color = torch.where((intensity > 0)[None, :],
                             torch.stack([intensity] * 3),
                             torch.stack([zero, -intensity, -intensity]))
    return torch.where(found[None, :], hit_color, miss_color)


def _frame_packed_composite(arrs, cfg, dyn, cam_origin, cam_t, fov_params,
                            groups, w, key, masks=None, stats=None,
                            fused=False):
    """One frame of a composite scene in one pass over all its rays ->
    packed int32 stream (or, with ``key=None``, (R, 3) float colors in
    linear pixel order; a dict passed as ``masks`` then receives the
    frame's diagnostic masks in the same order, one passed as ``stats`` its
    counters).  ``fused`` (``_glue_fused``, on one device) runs the glue
    after the primary walk as one kernel (``shade_pack``); the counter
    ``glue_fused`` says so."""
    pctx = primary_ctx(arrs, cfg, cam_origin)
    xs, ys, unswz = _frame_coords(groups, w, cam_origin.device)
    oT, dT = make_rays(cam_origin, cam_t, *fov_params, xs, ys)
    _stat(stats, "glue_fused", lambda: int(fused))
    if fused:
        skip = torch.full((oT.shape[1],), -1, dtype=torch.int32,
                          device=oT.device)
        walk = _walk(arrs, cfg, oT, dT, skip, True, None, pctx, 0, stats)
        with tracing.span("dispatch.shade", depth=0):
            return shade_pack(arrs, cfg, dyn, cam_origin, dT, walk, key,
                              groups, w, unswz)
    colorsT = _ray_colors_T(arrs, cfg, dyn, oT, dT, pctx=pctx, masks=masks,
                            stats=stats)
    if masks is not None:
        for name in masks:
            masks[name] = unswz(masks[name])
    if key is None:
        return unswz(colorsT.T)
    with tracing.span("dispatch.pack"):
        return packing.pack_device_stream(colorsT, key, permute=unswz)


def _frame_packed_box(d, cam_origin, cam_t, fov_params, groups, w, key):
    xs, ys, unswz = _frame_coords(groups, w, cam_origin.device)
    colorsT = _box_colors(d, cam_origin, cam_t, fov_params, xs, ys)
    if key is None:
        return unswz(colorsT.T)
    with tracing.span("dispatch.pack"):
        return packing.pack_device_stream(colorsT, key, permute=unswz)


def _needs_host_pack(fmt) -> bool:
    """Integer channels wider than 23 bits exceed what the device packer's
    float32 rounding carries: such a format ships float colors and is packed
    on the host with the reference's exact 64-bit math (12 bytes a pixel
    cross to the host instead of ``bytes_per_pixel``)."""
    return any((not ch.tfloat) and ch.bit_size > 23 for ch in fmt.channels)


def _camera(scene, width, height, device):
    """The view's ray parameters and the camera's origin and axes on
    ``device``."""
    with tracing.span("dispatch.camera"):
        scene._set_view_size(width, height)
        fov = _fov_params(width, height, scene.fov)
        cam_origin, cam_t = _to_device(device, scene._cam._origin,
                                       scene._cam._t)
    return fov, cam_origin, cam_t


def _frame_inputs(scene):
    """What a composite frame takes from the scene that may change between
    frames of one graph key: the camera's origin and axes and the ambient
    and background colors, as one float32 vector."""
    return np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in (
        scene._cam._origin, scene._cam._t,
        *(list(getattr(scene, k)) for k in _DYN))])


def _split_inputs(inputs, d):
    """``_frame_inputs`` on the device -> (camera origin (d,), axes (d, d),
    the dict of colors ``_scene_dyn`` gives), views of ``inputs``."""
    dyn = inputs[d + d * d:].view(len(_DYN), 3)
    return (inputs[:d], inputs[d:d + d * d].view(d, d),
            dict(zip(_DYN, dyn)))


def _frame(scene, width, height, key, device, masks=None, stats=None):
    """Dispatch one frame on ``device``; returns the device tensor.  While
    tracing is on, a frame given no ``stats`` counts into the recorder's
    dict for its frame (``tracing.frame_counters``).  A composite frame
    that ``graphs.eligible`` takes runs from its CUDA graphs from the
    second frame of its key (``graphs.frame_key``) on; the counters
    ``graphs.COUNTERS`` say whether it replayed and captured."""
    if stats is None:
        stats = tracing.frame_counters()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    groups = _frame_groups(-(-(width * height) // TILE))
    check_scene(scene, (CompositeScene, BoxScene))
    if not isinstance(scene, CompositeScene):
        fov, cam_origin, cam_t = _camera(scene, width, height, device)
        return _frame_packed_box(scene.dimension, cam_origin, cam_t, fov,
                                 groups, width, key)
    cfg, arrs, _flat = get_device_scene(scene, device)
    with tracing.span("dispatch.camera"):
        scene._set_view_size(width, height)
        fov = _fov_params(width, height, scene.fov)
        host = _frame_inputs(scene)

    fused = masks is None and _glue_fused(arrs, cfg, key)

    def body(inputs, stats):
        cam_origin, cam_t, dyn = _split_inputs(inputs, cfg.d)
        return _frame_packed_composite(arrs, cfg, dyn, cam_origin, cam_t,
                                       fov, groups, width, key, masks=masks,
                                       stats=stats, fused=fused)

    if stats is not None:
        stats.update(dict.fromkeys(graphs.COUNTERS, 0))
    if graphs.eligible(device, arrs, masks, _scan(arrs)):
        out = graphs.frame(scene, graphs.frame_key(
            scene, cfg, device, width, height, key, fov, stats is not None),
            device, host, body, stats)
        if out is not None:
            return out
    with tracing.span("dispatch.camera"):
        inputs, = _to_device(device, host)
    return body(inputs, stats)


def frame_device_arrays(scene, fmt, device):
    """Dispatch one full frame and return its device tensor without pulling
    it to the host: the packed int32 stream, or for a format that
    ``_needs_host_pack`` the (R, 3) float colors, in linear pixel order
    (padded to whole tiles)."""
    key = None if _needs_host_pack(fmt) else packing.format_key(fmt)
    return _frame(scene, fmt.width, fmt.height, key, device)


def frame_colors(scene, width, height, device, masks=False):
    """Float colors of one frame, (height, width, 3) numpy float32.

    With ``masks`` (composite scenes) also a dict of (height, width) bool
    arrays that say what the engine found at each pixel, for choosing the
    pixels of a check: ``hit``, ``layered`` and ``full`` of the primary
    trace (``_primary_masks``), and over all shadow queries
    ``shadowed`` (a wanted query ended blocked), ``filtered`` (one ended
    unblocked behind glass) and ``grazing`` (one was cast for a light flatter
    than GRAZING_SINE on its surface)."""
    found = {} if masks else None
    out = _frame(scene, width, height, None, device, masks=found)
    colors = out[:width * height].cpu().numpy().reshape(height, width, 3)
    if not masks:
        return colors
    none = np.zeros((height, width), bool)
    found = {k: v[:width * height].cpu().numpy().reshape(height, width)
             for k, v in found.items()}
    return colors, {k: found.get(k, none) for k in (
        "hit", "layered", "full", "shadowed", "filtered", "grazing")}


def frame_stats(scene, width, height, device="cuda"):
    """The counters of one frame of the composite ``scene`` at ``width`` x
    ``height`` on ``device`` (the JAX package's ``frame_stats``), as Python
    ints: ``rays_traced`` and ``chunks_visited`` (the traces: rays and
    chunk visits of the walks, or the chunk scan's chunk runs; the grid
    walk counts rays only), ``shadow_rays`` and ``occl_chunks_visited``
    (the shadow queries' active rays and visits; the grid walk counts
    neither), ``grid_tiles_visited`` and ``occl_grid_tiles_visited`` (the
    grid walks' 512-triangle tiles run, summed over their 512-ray blocks
    at every depth: kernels 2.9 and 2.10; the JAX package has neither;
    only a scene of d > 8 with an opaque pool has them), and at each
    bounce depth n the live rays
    ``bounce_live_rays_d{n}`` and the 512-ray blocks with a live ray
    ``bounce_live_blocks_d{n}``, ``graphs.COUNTERS`` (1 where the
    frame replayed, and captured, its glue's CUDA graphs) and
    ``glue_fused`` (1 where the glue after the walk ran as one kernel,
    ``shade_pack``; never in this frame of float colors).  The frame is
    rendered as ``_frame`` does, in its groups (``_frame_groups``), and not
    pulled."""
    check_scene(scene, CompositeScene)
    stats = {}
    _frame(scene, width, height, None, device, stats=stats)
    return {k: int(v) for k, v in stats.items()}


def render_devices(device):
    """The devices a renderer of ``device`` renders on: every card for the
    unindexed ``"cuda"`` (a frame is then split by pixels over them, as the
    JAX package splits it over ``jax.devices()``), else ``device``
    alone."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _ready(out):
    """A CUDA event recorded after the work that makes ``out``, on its
    device's current stream (None on the CPU)."""
    if not out.is_cuda:
        return None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(out.device))
    return ready


class Slabs(list):
    """A dispatched frame's slabs, ``[(start_px, tensor, ready)]``, and its
    frame id (``tracing.new_frame``; None while tracing is off), which the
    spans of its pull carry."""

    def __init__(self, slabs, frame=None):
        super().__init__(slabs)
        self.frame = frame


def dispatch_packed(scene, fmt, device):
    """Dispatch one full frame on ``device``; returns its slabs
    (``Slabs``), ``[(start_px, tensor, ready)]``, whose pulls complete the
    frame.

    The frame is one pass over all its rays; its output is cut into the
    JAX package's slabs (``_frame_slabs``), views of the one tensor, so
    abort is polled as often as there.  ``ready`` is a CUDA event recorded
    after the pass on the device's current stream (None on the CPU).  When
    ``render_devices`` gives several devices, the frame is split by pixels
    over them (``parallel.mesh.dispatch_sharded``), one slab a device.  All
    scene state is captured here: the caller may change the scene as soon
    as this returns.  The dispatch is the span ``frame.dispatch`` of a new
    frame."""
    frame = tracing.new_frame()
    with tracing.span("frame.dispatch", frame=frame):
        devices = render_devices(device)
        if len(devices) > 1:
            from ..parallel import mesh as pmesh
            return Slabs(pmesh.dispatch_sharded(scene, fmt, devices), frame)
        out = frame_device_arrays(scene, fmt, device)
        # a row of the packed stream holds 4 pixels, a row of colors one
        rows_px = 4 if out.dtype == torch.int32 else 1
        ready = _ready(out)
    n_tiles = -(-(fmt.width * fmt.height) // TILE)
    return Slabs([(s0 * TILE,
                   out[s0 * TILE // rows_px:(s0 + nt) * TILE // rows_px],
                   ready)
                  for s0, nt in _frame_slabs(n_tiles)], frame)


def _write_pixels(view, fmt, data, start_px, total):
    """Copy packed pixel bytes into the destination buffer, honoring
    ``fmt.pitch`` (non-contiguous rows)."""
    bpp = fmt.bytes_per_pixel
    count = min(data.shape[0], total - start_px)
    flat = data[:count].reshape(-1)
    if fmt.pitch == fmt.width * bpp:
        view[start_px * bpp:(start_px + count) * bpp] = flat.tobytes()
        return
    p = start_px
    off = 0
    while p < start_px + count:
        y, x = divmod(p, fmt.width)
        n = min(fmt.width - x, start_px + count - p)
        dst = y * fmt.pitch + x * bpp
        view[dst:dst + n * bpp] = flat[off:off + n * bpp].tobytes()
        off += n * bpp
        p += n


def _to_host(data, ready):
    """A slab's values as a numpy array.  A slab on the card is copied on a
    copy stream that waits only for its frame's pass (``ready``), into
    pinned memory, and only that copy is waited for: a pull issued after
    the next frame's work was enqueued on the device's stream does not wait
    for that work."""
    if not data.is_cuda:
        return data.numpy()
    stream = torch.cuda.Stream(data.device)
    host = torch.empty(data.shape, dtype=data.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        host.copy_(data, non_blocking=True)
        # the caching allocator keeps the slab until the copy has read it
        data.record_stream(stream)
        copied = torch.cuda.Event()
        copied.record(stream)
    copied.synchronize()
    return host.numpy()


def pull_packed(slabs, fmt, view, abort_check) -> bool:
    """Pull dispatched slabs into the writable byte ``view``; returns
    False when aborted (polled before each slab).  A packed int32 stream is
    the pixels' bytes; float colors are packed here, exactly.  The pull is
    the span ``frame.pull`` of the slabs' frame, each slab's copy and wait
    ``pull.wait``, its host packing ``pull.pack`` and its write into
    ``view`` ``pull.write``."""
    total = fmt.width * fmt.height
    with tracing.span("frame.pull", frame=getattr(slabs, "frame", None)):
        for start_px, dev, ready in slabs:
            if abort_check():
                return False
            with tracing.span("pull.wait"):
                data = _to_host(dev, ready)
            if data.dtype == np.int32:
                data = data.view(np.uint8).reshape(-1, fmt.bytes_per_pixel)
            else:
                with tracing.span("pull.pack"):
                    data = packing.pack_flat(data[:total - start_px], fmt)
            with tracing.span("pull.write"):
                _write_pixels(view, fmt, data, start_px, total)
    return True


def render_packed(scene, fmt, view, abort_check, device) -> bool:
    """Render a full frame into the writable byte ``view``; returns False
    when aborted."""
    if abort_check():
        return False
    slabs = dispatch_packed(scene, fmt, device)
    return pull_packed(slabs, fmt, view, abort_check)


# ---------------------------------------------------------------------------
# Strips
# ---------------------------------------------------------------------------

def _strip_coords(width, y0, nrows):
    """Pixel coordinates of rows ``y0`` .. ``y0 + nrows - 1`` in linear
    order (no tile swizzle), as the JAX package's strips take them."""
    xs, ys = np.meshgrid(np.arange(width, dtype=np.float32),
                         np.arange(y0, y0 + nrows, dtype=np.float32))
    return xs.ravel(), ys.ravel()


def _tiled(fn, xs, ys, device):
    """``fn`` over batches of TILE rays, the last padded by pixel (0, 0),
    so the walks form the blocks of the JAX package's strips.  ``fn`` takes
    (TILE,) coordinates on ``device`` to (3, TILE) colors; -> (n, 3) numpy
    float32."""
    n = xs.shape[0]
    out = np.empty((n, 3), dtype=np.float32)
    for s in range(0, n, TILE):
        e = min(s + TILE, n)
        txs = np.zeros(TILE, np.float32)
        tys = np.zeros(TILE, np.float32)
        txs[:e - s] = xs[s:e]
        tys[:e - s] = ys[s:e]
        colorsT = fn(torch.from_numpy(txs).to(device),
                     torch.from_numpy(tys).to(device))
        out[s:e] = colorsT[:, :e - s].T.cpu().numpy()
    return out


def render_strip_composite(scene, fmt, y0, nrows, device):
    """Float colors of ``nrows`` rows of a composite scene's frame from row
    ``y0``: (nrows, width, 3) numpy float32."""
    device = torch.device(device)
    cfg, arrs, _flat = get_device_scene(scene, device)
    fov, cam_origin, cam_t = _camera(scene, fmt.width, fmt.height, device)
    dyn = _scene_dyn(scene, device)

    def colors(xs, ys):
        oT, dT = make_rays(cam_origin, cam_t, *fov, xs, ys)
        return _ray_colors_T(arrs, cfg, dyn, oT, dT)

    out = _tiled(colors, *_strip_coords(fmt.width, y0, nrows), device)
    return out.reshape(nrows, fmt.width, 3)


def render_strip_box(scene, fmt, y0, nrows, device):
    """``render_strip_composite`` of a BoxScene."""
    device = torch.device(device)
    check_scene(scene, BoxScene)
    fov, cam_origin, cam_t = _camera(scene, fmt.width, fmt.height, device)

    def colors(xs, ys):
        return _box_colors(scene.dimension, cam_origin, cam_t, fov, xs, ys)

    out = _tiled(colors, *_strip_coords(fmt.width, y0, nrows), device)
    return out.reshape(nrows, fmt.width, 3)
