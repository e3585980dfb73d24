"""PyTorch wavefront renderer: a whole frame of rays advances in lockstep.

The counterpart of ``ntracer_tpu/engine/wavefront.py`` for triangle
``CompositeScene``s with d <= 8 (lights, shadows, reflections and
transparent materials included) and for ``BoxScene``: rays are generated in
32x16-pixel tile order, traced by the nearest-hit walk
(``resident_kernels.nearest_hit``), shaded -- with one occlusion walk
(``resident_kernels.occluded``) per light when the scene casts shadows --
bounced, packed to pixel bytes on the device, and pulled into the caller's
buffer.  A scene with a transparent material takes the transparent walks
instead (``nearest_hit_transparent``: the nearest opaque hit and the K
nearest transparent hits; ``occluded_transparent``: shadows filtered by the
glass they cross) and composes the K hits far to near over the opaque
color.  A pool whose layouts take more than ``rk.STREAM_POOL_BYTES`` (the
JAX package's line) takes the streaming variants of the same four walks
(``*_hbm``), as the JAX package does.  Function names follow the JAX module
so each has a visible counterpart.

Layouts stay lane-major as in the JAX package's transposed pipeline: rays
are (d, R), colors (3, R).  Every function takes tensors on one explicit
device; nothing falls back to another device.

Scenes this port does not cover yet raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import packing
from . import resident_kernels as rk
from .flatten import check_scene, flatten_composite, SceneConfig
from ..scene import BoxScene, CompositeScene

f32 = torch.float32
CHUNK = 512
TILE = 32768          # rays per dispatch group, as in the JAX package
MAX_GROUP_TILES = 64
TILE_W = 32
TILE_H = rk.RAY_BLOCK // TILE_W

REAL_MAX = float(np.finfo(np.float32).max)
# point lights dimmer than this cast no shadow ray (tracer.hpp:31)
LIGHT_THRESHOLD = 1.0 / 512.0
ROUNDING_FUZZ = float(np.float32(np.finfo(np.float32).eps * 10))
# Diagnostic masks (frame_colors): a light this flat on a surface is grazing
# -- its shadow ray runs along the surface, and rounding decides whether the
# surface's own neighbours block it
GRAZING_SINE = 1e-5


def _unsupported(what, item):
    return NotImplementedError(
        f"{what} is not ported to ntracer_tpu_torch yet "
        f"(ROADMAP.md section 1, item {item})")


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


def _ray_coords(start, w, count, device):
    """Pixel coordinates of one ``count``-ray group starting at linear pixel
    ``start``.  When the frame allows it, rays are ordered in TILE_W x TILE_H
    pixel tiles so each 512-ray walk block covers a compact 2-D region.
    Returns (xs, ys, swz): ``swz`` (or None) permutes per-pixel values of the
    group back to linear pixel order."""
    j = torch.arange(count, dtype=torch.int64, device=device)
    if w % TILE_W == 0 and count % w == 0 and (count // w) % TILE_H == 0:
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


def _frame_groups(n_tiles):
    """(start, count) of every ray group of a frame: the JAX package's slab
    split (at most 4 slabs) and group split (at most MAX_GROUP_TILES tiles),
    so the port forms the same 512-ray blocks of the same pixels."""
    n_slabs = max(1, min(4, n_tiles // 4))
    per = -(-n_tiles // n_slabs)
    groups = []
    for s0 in range(0, n_tiles, per):
        nt = min(per, n_tiles - s0)
        gt = min(nt, MAX_GROUP_TILES)
        while nt % gt:
            gt -= 1
        count = gt * TILE
        groups += [(s0 * TILE + i * count, count) for i in range(nt // gt)]
    return groups


def _frame_coords(groups, w, device):
    """Concatenated coordinates of ``groups`` and the frame's unswizzle:
    a function taking per-ray values (R, ...) to linear pixel order."""
    xs, ys, swzs = [], [], []
    for start, count in groups:
        x, y, swz = _ray_coords(start, w, count, device)
        xs.append(x)
        ys.append(y)
        swzs.append(swz)

    def unswizzle(v):
        parts = []
        off = 0
        for (_start, count), swz in zip(groups, swzs):
            part = v[off:off + count]
            parts.append(part if swz is None else swz(part))
            off += count
        return torch.cat(parts)

    return torch.cat(xs), torch.cat(ys), unswizzle


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
    package's ``get_device_scene``: the material rows, lights, bounds, and
    the chunked pool layouts with their slot-indexed rows
    ``res_slot_pack`` = [fn(d), mat, pool id], for a scene with a
    transparent material the per-slot opacity row ``res_opa``, and for a
    pool over ``rk.STREAM_POOL_BYTES`` the flag ``res_is_hbm``: the walks
    then stream its chunks.  The port's walks have no chunk limit
    (the JAX package falls back to its XLA scan at 16,383 chunks)."""
    a = flat.arrays
    d = flat.config.d
    n_tris = flat.config.n_tris
    arrs = {k: a[k] for k in ("bound_start", "bound_end", "pl_pos",
                              "pl_color", "gl_dir", "gl_color")}
    arrs["mat_pack"] = np.concatenate([
        np.asarray(a["mat_color"], np.float32),
        np.asarray(a["mat_specular"], np.float32),
        np.asarray(a["mat_opacity"], np.float32)[:, None],
        np.asarray(a["mat_refl"], np.float32)[:, None],
        np.asarray(a["mat_spec_int"], np.float32)[:, None],
        np.asarray(a["mat_spec_exp"], np.float32)[:, None],
    ], axis=1)
    arrs["tri_base"] = np.int32(0)

    fn_norm = np.linalg.norm(a["tri_fn"], axis=1)
    bins = rk.centroid_bins(a["cull_lo"], a["cull_hi"], fn_norm, rk.CK)
    if not bins:
        # no real triangle: one empty chunk keeps every layout non-empty
        # (its slots never hit, so every ray misses)
        zero = np.zeros(d, np.float32)
        bins = [(zero, zero, [])]
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
    if flat.config.has_transparency:
        tri_opacity = np.asarray(a["mat_opacity"], np.float32)[a["tri_mat"]]
        arrs["res_opa"] = rk.add_opacity(res, tri_opacity)["opa"]
    if rk.pool_bytes(len(bins) * rk.CK, d) > rk.STREAM_POOL_BYTES:
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


def get_device_scene(scene, device):
    """Flatten a CompositeScene and move its layouts to ``device``, cached
    on the scene as ``_torch_cache`` (keyed on ``scene._version`` and the
    device).  Render flags are re-read from the scene on every call."""
    check_scene(scene, CompositeScene)
    if scene.dimension > rk.C_PAD:
        raise _unsupported(f"a {scene.dimension}-D scene (d > 8)", 10)
    device = torch.device(device)
    key = (scene._version, str(device))
    cache = scene._torch_cache
    if cache is None or cache[0] != key:
        flat = flatten_composite(scene, chunk=CHUNK)
        cache = (key, flat.config,
                 tensors_from_arrays(device_arrays(flat), device), flat)
        scene._torch_cache = cache
    _key, cfg, arrs, flat = cache
    cfg = dataclasses.replace(
        cfg,
        shadows=bool(scene.shadows),
        camera_light=bool(scene.camera_light),
        max_reflect_depth=int(scene.max_reflect_depth),
        bg_axis=int(scene.bg_gradient_axis),
    )
    return cfg, arrs, flat


def check_supported(cfg: SceneConfig):
    """Raise NotImplementedError for scene features outside this port
    (d > 8 is refused earlier, by get_device_scene)."""
    if cfg.n_solids:
        raise _unsupported("solids", 8)


def _scene_dyn(scene, device):
    return {k: torch.tensor(list(getattr(scene, k)), dtype=f32,
                            device=device)
            for k in ("ambient", "bg1", "bg2", "bg3")}


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


def _streams(arrs):
    """Whether the scene's pool is over the line: its walks stream."""
    return "res_is_hbm" in arrs


def primary_ctx(arrs, cfg, origin):
    """Per-frame context of the shared-origin (primary) trace: the
    front-to-back chunk order and the hoisted origin-dot rows."""
    res = _res_dict(arrs)
    order, dmin = rk.chunk_order(res["klo"], res["khi"], origin)
    return {"order": order, "dmin": dmin,
            "sh_res": rk.shared_rows_res(res["gt"], res["ci"], origin,
                                         cfg.d)}


def _trace_finish_T(arrs, cfg, dT, res, K):
    """The (k, R) finish of a trace on one device.  With K transparent
    slots (``ttT``/``tslotT`` (K, R), sorted ascending by t): the slots'
    view-facing normals ``tnormT`` (d, K, R), materials ``tmatT`` and pool
    ids ``tidT`` (K, R) in one gather of the slot rows, then the trim: a
    slot counts only in front of the opaque hit.  Solids are not ported."""
    if cfg.n_solids:
        raise _unsupported("solids", 8)
    d = cfg.d
    if K:
        tslot = res.pop("tslotT")
        rows = arrs["res_slot_pack"][torch.clamp(tslot, min=0).long()] \
            .permute(2, 0, 1)                               # (d + 2, K, R)
        fnk = rows[:d]
        denomk = _dotT(fnk, dT[:, None, :])
        res["tnormT"] = _unitT(fnk) \
            * torch.where(denomk > 0, -1.0, 1.0)[None, :, :]
        res["tmatT"] = rows[d].to(torch.int32)
        tid = torch.where(tslot >= 0,
                          rows[d + 1].to(torch.int32) + arrs["tri_base"], -1)
    res["hit"] = res["pid"] >= 0
    if K:
        tvalid = (tid >= 0) & (res["ttT"] < res["t"][None, :])
        res["tidT"] = torch.where(tvalid, tid, -1)
    return res


def trace_pool(arrs, cfg: SceneConfig, oT, dT, skip, shared_origin=None,
               active=None, pctx=None):
    """Nearest opaque hit of (d, R) rays over the triangle pool and, for a
    scene with a transparent material, the K = ``cfg.max_transparent_hits``
    nearest transparent hits in front of it.

    ``shared_origin`` (d,) selects the front-to-back order and shared rows of
    primary rays (``pctx`` from primary_ctx, computed here when absent);
    ``active`` masks bounce rays out.  Returns t, pid, mat (R,) and pointT,
    normalT (d, R); with K also ttT, tidT, tmatT (K, R) and tnormT
    (d, K, R), slots sorted ascending by t, ``tidT`` -1 where empty."""
    K = cfg.max_transparent_hits if cfg.has_transparency else 0
    d = cfg.d
    res_k = _res_dict(arrs)
    skip_local = skip - arrs["tri_base"]
    order = sh = None
    if shared_origin is not None:
        if pctx is None:
            pctx = primary_ctx(arrs, cfg, shared_origin)
        order, sh = pctx["order"], pctx["sh_res"]
    res = {}
    if K:
        nearest_t = rk.nearest_hit_transparent_hbm if _streams(arrs) \
            else rk.nearest_hit_transparent
        kt, slot, ktt, ktslot, _vis = nearest_t(
            res_k, oT, dT, skip_local, d, K, order=order, active=active,
            sh=sh)
        # stable, as jnp.argsort is: exactly tied surfaces keep slot order
        order_k = torch.argsort(ktt, dim=0, stable=True)
        res["ttT"] = torch.gather(ktt, 0, order_k)
        res["tslotT"] = torch.gather(ktslot, 0, order_k)
    else:
        nearest = rk.nearest_hit_hbm if _streams(arrs) else rk.nearest_hit
        kt, slot, _vis = nearest(res_k, oT, dT, skip_local, d, order=order,
                                 active=active, sh=sh)
    rowT = arrs["res_slot_pack"][torch.clamp(slot, min=0).long()].T
    gidl = rowT[d + 1].to(torch.int32)
    t = torch.where(slot >= 0, kt, REAL_MAX)
    pid = torch.where(slot >= 0, gidl + arrs["tri_base"], -1)
    pointT = oT + t[None, :] * dT
    fnT = rowT[:d]
    denom = _dotT(fnT, dT)
    normalT = _unitT(fnT) * torch.where(denom > 0, -1.0, 1.0)[None, :]
    res.update(t=t, pid=pid, pointT=pointT, normalT=normalT,
               mat=rowT[d].to(torch.int32))
    return _trace_finish_T(arrs, cfg, dT, res, K)


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


def occlusion(arrs, cfg: SceneConfig, oT, dT, ldist, skip, clamp_exit=True):
    """Shadow query (light_reaches, tracer.hpp:1750-1766, with true any-hit
    semantics): is there an opaque hit with 0 < t < ``ldist`` along each
    (d, R) ray, and how much light do the transparent hits in that range let
    through?  -> (blocked (R,) bool, filt): ``filt`` (R,) f32 is the product
    of (1 - opacity) over those hits, 1 where ``blocked``; None in a scene
    without a transparent material (nothing filters, and the caller skips
    the multiply).

    Rays with ``ldist <= 0`` are inactive; the walk skips ray blocks without
    an active ray, so a wholly inactive batch costs one short launch and no
    host sync.  ``clamp_exit`` cuts ``ldist`` to the ray's exit from the
    pool's box, which bounds a global light's infinite distance (no pool hit
    lies beyond it); point-light queries arrive finite and skip it.  ``skip``
    is the pool id of the surface the ray leaves."""
    res_k = _res_dict(arrs)
    skip_local = skip - arrs["tri_base"]
    if clamp_exit:
        pool_ldist = torch.minimum(
            ldist, rk._scene_exit_T(oT, dT, res_k["b_lo"], res_k["b_hi"]))
    else:
        pool_ldist = ldist
    if cfg.has_transparency:
        occ_t = rk.occluded_transparent_hbm if _streams(arrs) \
            else rk.occluded_transparent
        blocked, filt, _vis = occ_t(res_k, oT, dT, pool_ldist, skip_local,
                                    cfg.d)
    else:
        occ = rk.occluded_hbm if _streams(arrs) else rk.occluded
        blocked, _vis = occ(res_k, oT, dT, pool_ldist, skip_local, cfg.d)
        filt = None
    return _occlusion_finish(cfg, blocked, filt)


def _occlusion_finish(cfg, blocked, filt):
    """What the pool walk does not cover: solids are tested here, against
    the unclamped ``ldist`` (not ported)."""
    if cfg.n_solids:
        raise _unsupported("solids", 8)
    return blocked, filt


def _note(masks, name, rays):
    """OR ``rays`` (R,) bool into the frame's diagnostic mask ``name``."""
    if masks is not None:
        masks[name] = rays | masks[name] if name in masks else rays


def shade_local_T(arrs, cfg: SceneConfig, dT, pointT, normalT, pid, mi, depth,
                  dyn, active=None, masks=None):
    """Local shading (tracer.hpp:1768-1854): (d, R) geometry -> (3, R)
    color, (3, R) child coefficient, (d, R) child direction.  With
    ``cfg.shadows`` every light casts one occlusion query from the hit
    points (skipping the surface ``pid`` they lie on), for the rays in
    ``active`` that face the light.  ``masks`` (a dict, see
    ``frame_colors``) gathers what the queries found."""
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
                                      clamp_exit=False)
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
                                      torch.where(want, REAL_MAX, 0.0), pid)
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


def _ray_colors_T(arrs, cfg: SceneConfig, dyn, oT, dT, pctx=None, masks=None):
    """Color of (d, R) rays (ray_color, tracer.hpp:1856-1883) with
    reflections unrolled into a weighted bounce loop: bounce rays trace
    with an active mask and skip the surface they leave.  -> (3, R) rows,
    ready for the channel packer (the JAX package's
    ``ray_colors_packable`` on its transposed pipeline).  A dict passed as
    ``masks`` is filled with the frame's diagnostic masks (see
    ``frame_colors``)."""
    check_supported(cfg)
    R = oT.shape[1]
    dev = oT.device
    out = torch.zeros((3, R), dtype=f32, device=dev)
    weight = torch.ones((3, R), dtype=f32, device=dev)
    active = torch.ones((R,), dtype=torch.bool, device=dev)
    skip = torch.full((R,), -1, dtype=torch.int32, device=dev)
    max_bounces = cfg.max_reflect_depth if cfg.has_reflectivity else 0

    for depth in range(max_bounces + 1):
        res = trace_pool(arrs, cfg, oT, dT, skip,
                         shared_origin=oT[:, 0] if depth == 0 else None,
                         active=None if depth == 0 else active,
                         pctx=pctx if depth == 0 else None)
        if masks is not None and depth == 0:
            masks.update(_primary_masks(res))
        dist = aabb_distance_T(cfg, arrs, oT, dT)
        hit = res["hit"] & (dist >= 0)
        live = hit if depth == 0 else hit & active
        localT, child_coefT, child_dirT = shade_local_T(
            arrs, cfg, dT, res["pointT"], res["normalT"], res["pid"],
            res["mat"], depth, dyn, active=live, masks=masks)
        bgT = background_T(cfg, dyn, dT)
        color_hereT = torch.where(hit[None, :], localT, bgT)
        weight_scale = None
        if cfg.has_transparency:
            color_hereT, weight_scale = _compose_transparent_T(
                arrs, cfg, dyn, oT, dT, res, color_hereT, depth, masks=masks)
        out = out + torch.where(active[None, :], weight * color_hereT, 0.0)
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


def _compose_transparent_T(arrs, cfg, dyn, oT, dT, res, base_colorT, depth,
                           masks=None):
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
            masks=masks)
        op = arrs["mat_pack"][mi.long(), 6]
        new = localT * op[None, :] + color * (1 - op)[None, :]
        color = torch.where(valid[None, :], new, color)
        trans = torch.where(valid, trans * (1 - op), trans)
    return color, trans


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
                            groups, w, key, masks=None):
    """One frame of a composite scene in one pass over all its rays ->
    packed int32 stream (or, with ``key=None``, (R, 3) float colors in
    linear pixel order; a dict passed as ``masks`` then receives the
    frame's diagnostic masks in the same order)."""
    pctx = primary_ctx(arrs, cfg, cam_origin)
    xs, ys, unswz = _frame_coords(groups, w, cam_origin.device)
    oT, dT = make_rays(cam_origin, cam_t, *fov_params, xs, ys)
    colorsT = _ray_colors_T(arrs, cfg, dyn, oT, dT, pctx=pctx, masks=masks)
    if masks is not None:
        for name in masks:
            masks[name] = unswz(masks[name])
    if key is None:
        return unswz(colorsT.T)
    return packing.pack_device_stream(colorsT, key, permute=unswz)


def _frame_packed_box(d, cam_origin, cam_t, fov_params, groups, w, key):
    xs, ys, unswz = _frame_coords(groups, w, cam_origin.device)
    colorsT = _box_colors(d, cam_origin, cam_t, fov_params, xs, ys)
    if key is None:
        return unswz(colorsT.T)
    return packing.pack_device_stream(colorsT, key, permute=unswz)


def _needs_host_pack(fmt) -> bool:
    """Integer channels wider than 23 bits need the exact host packer."""
    return any((not ch.tfloat) and ch.bit_size > 23 for ch in fmt.channels)


def _frame(scene, width, height, key, device, masks=None):
    """Dispatch one frame on ``device``; returns the device tensor."""
    device = torch.device(device)
    scene._set_view_size(width, height)
    fov = _fov_params(width, height, scene.fov)
    cam_origin = torch.as_tensor(np.asarray(scene._cam._origin, np.float32),
                                 device=device)
    cam_t = torch.as_tensor(np.asarray(scene._cam._t, np.float32),
                            device=device)
    groups = _frame_groups(-(-(width * height) // TILE))
    check_scene(scene, (CompositeScene, BoxScene))
    if isinstance(scene, CompositeScene):
        cfg, arrs, _flat = get_device_scene(scene, device)
        return _frame_packed_composite(arrs, cfg, _scene_dyn(scene, device),
                                       cam_origin, cam_t, fov, groups, width,
                                       key, masks=masks)
    return _frame_packed_box(scene.dimension, cam_origin, cam_t, fov, groups,
                             width, key)


def frame_device_arrays(scene, fmt, device):
    """Dispatch one full frame and return the packed device tensor without
    pulling it to the host (for timing the device's work)."""
    if _needs_host_pack(fmt):
        raise _unsupported("integer channels wider than 23 bits", 13)
    return _frame(scene, fmt.width, fmt.height, packing.format_key(fmt),
                  device)


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


def dispatch_packed(scene, fmt, device):
    """Dispatch one full frame; returns ``[(start_px, device_tensor)]``."""
    return [(0, frame_device_arrays(scene, fmt, device))]


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


def pull_packed(slabs, fmt, view, abort_check) -> bool:
    """Pull dispatched slabs into the writable byte ``view``; returns
    False when aborted."""
    total = fmt.width * fmt.height
    for start_px, dev in slabs:
        if abort_check():
            return False
        data = dev.cpu().numpy().view(np.uint8).reshape(
            -1, fmt.bytes_per_pixel)
        _write_pixels(view, fmt, data, start_px, total)
    return True


def render_packed(scene, fmt, view, abort_check, device) -> bool:
    """Render a full frame into the writable byte ``view``; returns False
    when aborted."""
    if abort_check():
        return False
    slabs = dispatch_packed(scene, fmt, device)
    return pull_packed(slabs, fmt, view, abort_check)
