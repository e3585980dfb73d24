"""Grid walks over a flat triangle pool for scenes of more than 8
dimensions: nearest hit and any-hit occlusion.

The PyTorch counterpart of ``ntracer_tpu/engine/pallas_kernels.py``:

  * host prep (numpy, once per scene): ``prepare_tri_arrays``, a copy of the
    JAX package's function (which cannot be imported without jax): plane
    rows ``gt`` (d*d, T), plane-major with the face normal first, offset
    rows ``ci`` (d, T) with row 0 = -dc, and per 512-triangle tile the box
    ``k_lo``/``k_hi`` and the flag ``k_any`` of its real triangles;
  * per-frame prep (plain torch): ``shared_rows`` (the origin dots of
    primary rays, computed once per frame) and the pool exit
    (``resident_kernels._scene_exit_T``, the same operations as the JAX
    package's ``_scene_exit``);
  * the walks: ``nearest_hit`` and ``occluded`` launch the hand-written
    CUDA kernels (``ntracer_tpu_torch/csrc/grid_walk.cu``) on CUDA tensors
    and take their plain twins (``nearest_hit_ref``, ``occluded_ref``) on
    CPU tensors.

The walk is the TPU kernel's grid of (512-ray x 512-triangle) tiles: each
512-ray block visits the pool's tiles in flatten order, with no front-to-
back order and no candidate scan.  Before a tile, with the carry from
before it, the block votes: the tile runs when ``k_any`` holds and some ray
of the block enters the tile's box before its best t (the occlusion walk:
before its ``ldist``, on a ray not blocked yet).  In a tile that runs, a
ray takes the nearest valid hit over the 512 lanes, the lowest lane on a
tie, and replaces its carry only on strict ``<``.  ``init_t``, the first
carry, is the ray's exit from the pool's box x (1 + 16 fuzz), 0 for a ray
that misses the box.  Ids are pool ids (tile * 512 + lane), -1 on a miss.
Kernel and twin keep that rule and the same float operations in the same
order (no FMA contraction), so they agree bit for bit; both also report how
many tiles each block ran.
"""

from __future__ import annotations

import numpy as np
import torch

from . import graphs
from . import resident_kernels as rk

RAY_BLOCK = 512   # rays per block: one 32x16-pixel tile of the frame
TRI_BLOCK = 512   # triangles per tile
# the least d the CUDA kernels run on their wide bodies (d at run time, the
# same shared memory and registers at every d); d = 3..16 take the bodies
# templated on d.  The twins take any d.
WIDE_D = 17


# ---------------------------------------------------------------------------
# Host prep (numpy, once per scene)
# ---------------------------------------------------------------------------

def prepare_tri_arrays(tri_p1, tri_fn, tri_en, tri_dc, tri_lo, tri_hi, d):
    """Kernel-friendly triangle layouts (host side, once per scene).

    Returns a dict of numpy arrays: ``gt`` (d*d, T) plane rows (plane-major,
    coordinate-minor rows; face normal first), ``ci`` (d, T) with row 0 the
    plane offset -dc and rows 1..d-1 the edge offsets e_i . p1, and
    per-TRI_BLOCK AABBs ``k_lo``/``k_hi`` (T/TRI_BLOCK, 1, d) of the real
    triangles with the flag ``k_any`` (T/TRI_BLOCK, 1, 1), and the pool's
    box ``b_lo``/``b_hi`` (d,)."""
    T = tri_p1.shape[0]
    assert T % TRI_BLOCK == 0
    planes = np.concatenate([tri_fn[:, None, :], tri_en], axis=1)  # (T, d, d)
    gt = np.ascontiguousarray(
        planes.transpose(1, 2, 0).reshape(d * d, T)).astype(np.float32)
    ci = np.zeros((d, T), np.float32)
    ci[0] = -tri_dc
    ci[1:] = np.einsum("tid,td->it", tri_en, tri_p1, dtype=np.float32)

    nk = T // TRI_BLOCK
    k_lo = np.zeros((nk, 1, d), np.float32)
    k_hi = np.zeros((nk, 1, d), np.float32)
    k_any = np.zeros((nk, 1, 1), np.float32)
    fn_norm = np.linalg.norm(tri_fn, axis=1)
    for k in range(nk):
        sl = slice(k * TRI_BLOCK, (k + 1) * TRI_BLOCK)
        real = fn_norm[sl] > 0
        if real.any():
            k_lo[k, 0] = tri_lo[sl][real].min(axis=0)
            k_hi[k, 0] = tri_hi[sl][real].max(axis=0)
            k_any[k, 0, 0] = 1.0
    if k_any.any():
        b_lo = k_lo[k_any[:, 0, 0] > 0, 0].min(axis=0)
        b_hi = k_hi[k_any[:, 0, 0] > 0, 0].max(axis=0)
    else:
        b_lo = np.zeros(d, np.float32)
        b_hi = np.zeros(d, np.float32)
    return dict(gt=gt, ci=ci, k_lo=k_lo, k_hi=k_hi, k_any=k_any,
                b_lo=b_lo, b_hi=b_hi)


def plane_records(gt, d):
    """The plane rows ``gt`` (d*d, T) laid out triangle by triangle for the
    CUDA grid walks: (T, d, pw) float32 with pw = d rounded up
    to a multiple of 4 and zeros past d, so that ``rec[t, p, :d]`` is plane
    p of triangle t (``gt[p*d:(p+1)*d, t]``).  A run of triangles is one
    contiguous range, and each plane starts on a 16-byte boundary."""
    T = gt.shape[1]
    pw = -(-d // 4) * 4
    rec = torch.zeros((T, d, pw), dtype=torch.float32, device=gt.device)
    rec[:, :, :d] = gt.reshape(d, d, T).permute(2, 0, 1)
    return rec


# ---------------------------------------------------------------------------
# Per-frame prep (plain torch)
# ---------------------------------------------------------------------------

def shared_rows(gt, ci, origin, d):
    """Rows for rays that share one origin (a primary frame): row 0 is the
    t numerator ``ci[0] - o . n_0`` and row p the edge bound
    ``ci[p] - o . n_p``, the origin dots accumulated coordinate by
    coordinate from 0 as the per-ray pair test does, so the shared test is
    bit-equal to it.  -> (d, T)."""
    T = gt.shape[1]
    rows = []
    for p in range(d):
        acc = torch.zeros((T,), dtype=torch.float32, device=gt.device)
        for c in range(d):
            acc = acc + origin[c] * gt[p * d + c]
        rows.append(ci[p] - acc)
    return torch.stack(rows)


def _grid_inputs(kern, oT, dT, skip, d, sh=None, ldist=None):
    """What the kernels and the twins take: the rays, the start distance of
    the nearest-hit walk (``init_t``, the pool exit) or the occlusion
    walk's ``ldist``, and the pool's layouts (``ci`` replaced by ``sh`` in
    shared mode)."""
    R = oT.shape[1]
    if R % RAY_BLOCK:
        raise ValueError(f"ray count {R} is not a multiple of {RAY_BLOCK}")
    w = dict(d=d, shared=sh is not None, oT=oT, dT=dT, skip=skip,
             gt=kern["gt"], ci=kern["ci"] if sh is None else sh,
             k_lo=kern["k_lo"], k_hi=kern["k_hi"], k_any=kern["k_any"])
    if ldist is None:
        w["init_t"] = rk._scene_exit_T(oT, dT, kern["b_lo"], kern["b_hi"])
    else:
        w["ldist"] = ldist
    return w


# ---------------------------------------------------------------------------
# The plain twins
# ---------------------------------------------------------------------------

def _tile_pairs(d, shared, g, ci, base, o, dv, skip, ldist=None):
    """Pair test (tracer.hpp:411-440) of ``n`` ray blocks against one tile:
    (n, RB, TB) t and valid.  ``g`` (d*d, TB) and ``ci`` (d, TB) are the
    tile's rows, ``base`` its first pool id; ``o``/``dv`` (d, n, RB, 1),
    ``skip`` (n, RB, 1), ``ldist`` (n, RB, 1) for the occlusion test.  Plane
    dots accumulate coordinate by coordinate from 0."""
    n, rb = o.shape[1], o.shape[2]
    shape = (n, rb, g.shape[1])
    tmp = torch.empty(shape, dtype=torch.float32, device=g.device)

    def dots(p):
        acc_o = None if shared else torch.zeros(shape, dtype=torch.float32,
                                                device=g.device)
        acc_d = torch.zeros(shape, dtype=torch.float32, device=g.device)
        for c in range(d):
            row = g[p * d + c]
            if not shared:
                torch.mul(o[c], row, out=tmp)
                acc_o.add_(tmp)
            torch.mul(dv[c], row, out=tmp)
            acc_d.add_(tmp)
        return acc_o, acc_d

    o0, denom = dots(0)
    t = ci[0] / denom if shared else (ci[0] - o0) / denom
    valid = (denom != 0) & (t > 0)
    if ldist is not None:
        valid &= t < ldist
    tot = torch.zeros(shape, dtype=torch.float32, device=g.device)
    for i in range(1, d):
        oi, di = dots(i)
        torch.mul(t, di, out=tmp)
        a = (ci[i] - tmp) if shared else (ci[i] - oi) - tmp
        valid &= (a >= -rk.ROUNDING_FUZZ) & (a <= rk.ONE_FUZZ)
        tot.add_(a)
    valid &= tot <= rk.ONE_FUZZ
    ids = base + torch.arange(g.shape[1], device=g.device)
    valid &= ids != skip
    return t, valid


def _grid_blocks(w, b0, b1):
    """Twin walk of ray blocks [b0, b1) over every tile in flatten order,
    vectorized over the blocks that run each tile.  Returns (best, best_id,
    tiles) for the nearest-hit walk, (blocked, None, tiles) with
    ``w["ldist"]``."""
    d = w["d"]
    nb = b1 - b0
    sl = slice(b0 * RAY_BLOCK, b1 * RAY_BLOCK)
    dev = w["oT"].device

    def blocks(x):                      # (k, R) slice -> (k, nb, RB)
        return x[:, sl].reshape(x.shape[0], nb, RAY_BLOCK)

    o = blocks(w["oT"])[..., None]                    # (d, nb, RB, 1)
    dv = blocks(w["dT"])[..., None]
    skip = w["skip"][sl].reshape(nb, RAY_BLOCK, 1)
    # slab entry of every ray into every tile's box: (nb, RB, tiles)
    k_lo_t = w["k_lo"][:, 0, :].T
    k_hi_t = w["k_hi"][:, 0, :].T
    entries = rk._entry_all(d, o, dv, k_lo_t, k_hi_t, k_lo_t.shape[1])
    occl = "ldist" in w
    if occl:
        ldist = w["ldist"][sl].reshape(nb, RAY_BLOCK)
        blocked = torch.zeros((nb, RAY_BLOCK), dtype=torch.bool, device=dev)
    else:
        best = w["init_t"][sl].reshape(nb, RAY_BLOCK).clone()
        best_id = torch.full((nb, RAY_BLOCK), -1, dtype=torch.int64,
                             device=dev)
    tiles = torch.zeros((nb,), dtype=torch.int32, device=dev)
    k_any = w["k_any"].reshape(-1).tolist()
    for j, any_j in enumerate(k_any):
        if any_j == 0:
            continue
        entry = entries[:, :, j]
        if occl:
            run = torch.any((entry < ldist) & ~blocked, dim=1)
        else:
            run = torch.any(entry < best, dim=1)
        sel = torch.nonzero(run).squeeze(1)
        if sel.numel() == 0:
            continue
        cols = slice(j * TRI_BLOCK, (j + 1) * TRI_BLOCK)
        t, valid = _tile_pairs(
            d, w["shared"], w["gt"][:, cols], w["ci"][:, cols],
            j * TRI_BLOCK, o[:, sel], dv[:, sel], skip[sel],
            ldist[sel][:, :, None] if occl else None)
        if occl:
            blocked[sel] |= torch.any(valid, dim=2)
        else:
            tm = torch.where(valid, t, float(rk.INF))
            ct = torch.amin(tm, dim=2)
            carg = rk._first_where(tm, ct[:, :, None], TRI_BLOCK)
            upd = ct < best[sel]
            best_id[sel] = torch.where(upd, j * TRI_BLOCK + carg,
                                       best_id[sel])
            best[sel] = torch.where(upd, ct, best[sel])
        tiles[sel] += 1
    if occl:
        return blocked, None, tiles
    return best, best_id, tiles


def _grid_ref(w):
    """The twin over all ray blocks, in steps of blocks whose
    (blocks, 512, 512) pair slabs stay within ``rk.TWIN_SLAB``: outputs do
    not depend on the step, blocks walk independently."""
    nb = w["oT"].shape[1] // RAY_BLOCK
    step = rk._twin_step(TRI_BLOCK, w["oT"].device.type)
    outs, ids, tiles = [], [], []
    for b0 in range(0, nb, step):
        a, i, v = _grid_blocks(w, b0, min(nb, b0 + step))
        outs.append(a.reshape(-1))
        if i is not None:
            ids.append(i.reshape(-1))
        tiles.append(v)
    if ids:
        return (torch.cat(outs), torch.cat(ids).to(torch.int32),
                torch.cat(tiles))
    return torch.cat(outs), torch.cat(tiles)


def nearest_hit_ref(kern, oT, dT, skip, d, sh=None):
    """Plain-torch twin of ``nearest_hit``: the same grid, the same block
    vote and the same float operations, over (blocks, 512, 512) slabs."""
    return _grid_ref(_grid_inputs(kern, oT, dT, skip, d, sh=sh))


def occluded_ref(kern, oT, dT, ldist, skip, d):
    """Plain-torch twin of ``occluded``: the same grid, vote and float
    operations, over (blocks, 512, 512) slabs."""
    return _grid_ref(_grid_inputs(kern, oT, dT, skip, d, ldist=ldist))


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------

GRID_INFO = ("registers", "local_bytes", "blocks_per_sm", "ring_slots",
             "shared_bytes", "rays_per_thread")


def launch_info(d, shared=False, walk="nearest_hit"):
    """A grid kernel at dimension ``d`` as it launches on the current card:
    kernel 2.9 (``walk="nearest_hit"``) in its ``shared`` (primary rays)
    variant or not, or kernel 2.10 (``walk="occluded"``; rays of their own
    origins).  Registers and local (spill) bytes a thread, blocks per SM,
    ring slots and shared bytes a block, rays a thread (``GRID_INFO``).  A
    wide body (d >= ``WIDE_D``) has no ring (0 slots), one ray a thread and
    the same registers, shared bytes and blocks an SM at every d."""
    from . import _build
    lib = _build.load()
    info = torch.zeros((len(GRID_INFO),), dtype=torch.int32)
    if walk == "nearest_hit":
        err = lib.ntr_grid_nearest_hit_info(d, int(shared), info.data_ptr())
    elif walk == "occluded":
        err = lib.ntr_grid_occluded_info(d, info.data_ptr())
    else:
        raise ValueError(f"no grid walk {walk!r}")
    if err:
        raise RuntimeError(f"grid {walk} kernel query failed: "
                           f"{_build.error_string(err)} ({err})")
    return dict(zip(GRID_INFO, info.tolist()))


def _plane_records(kern, w, dev, T):
    """The pool's plane records as the CUDA kernels read them:
    ``kern["grec"]``, or made from the plane rows when ``kern`` has none;
    checked with the offset rows for the ring's 16-byte aligned copies."""
    d = w["d"]
    grec = kern.get("grec")
    if grec is None:
        grec = plane_records(w["gt"], d)
    rk._check("grec", grec, torch.float32, (T, d, -(-d // 4) * 4), dev)
    for name, x in (("grec", grec), ("ci", w["ci"])):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    return grec


def _check_grid(w, dev):
    """Check what both kernels take; returns (R, T)."""
    d = w["d"]
    R = w["oT"].shape[1]
    T = w["gt"].shape[1]
    if d < 3:
        raise ValueError(f"the CUDA grid kernels take d >= 3, not d={d}")
    if T == 0 or T % TRI_BLOCK:
        raise ValueError(f"pool of {T} triangles is not a positive multiple "
                         f"of {TRI_BLOCK}")
    nj = T // TRI_BLOCK
    f32, i32 = torch.float32, torch.int32
    rk._check("oT", w["oT"], f32, (d, R), dev)
    rk._check("dT", w["dT"], f32, (d, R), dev)
    rk._check("skip", w["skip"], i32, (R,), dev)
    rk._check("gt", w["gt"], f32, (d * d, T), dev)
    rk._check("ci", w["ci"], f32, (d, T), dev)
    rk._check("k_lo", w["k_lo"], f32, (nj, 1, d), dev)
    rk._check("k_hi", w["k_hi"], f32, (nj, 1, d), dev)
    rk._check("k_any", w["k_any"], f32, (nj, 1, 1), dev)
    return R, T


def _grid_kernel(w, kern, dev, then=None):
    """Launch kernel 2.9 (walk inputs ``w`` with ``init_t``) or 2.10 (with
    ``ldist``) through ``graphs.launch`` (which calls ``then(error
    code)``), reading the plane rows as ``kern["grec"]``
    (``plane_records``, made here when ``kern`` has none); returns (error
    code, its outputs as the twin returns them)."""
    from . import _build
    lib = _build.load()
    R, T = _check_grid(w, dev)
    grec = _plane_records(kern, w, dev, T)
    tiles = torch.empty((R // RAY_BLOCK,), dtype=torch.int32, device=dev)
    head = (w["oT"].data_ptr(), w["dT"].data_ptr(), w["skip"].data_ptr())
    rows = (grec.data_ptr(), w["ci"].data_ptr(), w["k_lo"].data_ptr(),
            w["k_hi"].data_ptr(), w["k_any"].data_ptr(), T, R, w["d"])
    if "ldist" in w:
        rk._check("ldist", w["ldist"], torch.float32, (R,), dev)
        blocked = torch.empty((R,), dtype=torch.bool, device=dev)
        err = graphs.launch(lib.ntr_grid_occluded, (
            *head, w["ldist"].data_ptr(), *rows, blocked.data_ptr(),
            tiles.data_ptr()), dev, (w, grec, blocked, tiles), then)
        return err, (blocked, tiles)
    init_t = w["init_t"].contiguous()
    out_t = torch.empty((R,), dtype=torch.float32, device=dev)
    out_id = torch.empty((R,), dtype=torch.int32, device=dev)
    err = graphs.launch(lib.ntr_grid_nearest_hit, (
        *head, init_t.data_ptr(), *rows, int(w["shared"]), out_t.data_ptr(),
        out_id.data_ptr(), tiles.data_ptr()), dev,
        (w, grec, init_t, out_t, out_id, tiles), then)
    return err, (out_t, out_id, tiles)


def nearest_hit(kern, oT, dT, skip, d, sh=None):
    """Nearest opaque hit of each ray over the flat pool ``kern`` (the
    tensors of ``prepare_tri_arrays``).

    ``oT``/``dT`` (d, R) rays with R a multiple of 512, ``skip`` (R,) i32
    pool id never hit (or -1), ``sh`` (from shared_rows) selects the
    shared-origin pair test for primary rays.

    Returns (t (R,) f32, id (R,) i32 pool id or -1, tiles (R // 512,) i32
    tiles run per block); t is the start distance where id is -1.  On CUDA
    tensors the CUDA kernel runs (and ``nearest_hit.launches`` counts it),
    reading the plane rows as ``kern["grec"]`` (``plane_records``, made
    here when ``kern`` has none); on CPU tensors the plain twin
    ``nearest_hit_ref`` does."""
    w = _grid_inputs(kern, oT, dT, skip, d, sh=sh)
    if not rk._device("grid nearest_hit", oT.device):
        return _grid_ref(w)
    _err, out = _grid_kernel(w, kern, oT.device, rk._counted(
        "grid nearest_hit", nearest_hit))
    return out


nearest_hit.launches = 0


def occluded(kern, oT, dT, ldist, skip, d):
    """Any opaque hit with 0 < t < ``ldist`` over the flat pool ``kern``.

    ``oT``/``dT`` (d, R) rays with R a multiple of 512, ``ldist`` (R,) f32
    (<= 0 marks an inactive ray), ``skip`` (R,) i32 pool id never hit (or
    -1).  Returns (blocked (R,) bool, tiles (R // 512,) i32 tiles run per
    block).  On CUDA tensors the CUDA kernel runs (and
    ``occluded.launches`` counts it), reading the plane rows as
    ``kern["grec"]`` as ``nearest_hit`` does; on CPU tensors the plain twin
    ``occluded_ref`` does."""
    w = _grid_inputs(kern, oT, dT, skip, d, ldist=ldist)
    if not rk._device("grid occluded", oT.device):
        return _grid_ref(w)
    _err, out = _grid_kernel(w, kern, oT.device, rk._counted(
        "grid occluded", occluded))
    return out


occluded.launches = 0
