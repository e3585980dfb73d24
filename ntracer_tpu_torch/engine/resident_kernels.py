"""Front-to-back walks over a chunked triangle pool: nearest hit and
any-hit occlusion.

The PyTorch counterpart of ``ntracer_tpu/engine/resident_kernels.py``:

  * host prep (numpy, once per scene): ``centroid_bins`` cuts the pool into
    spatial bins of at most ``CK`` triangles and ``prepare_resident_cells``
    lays each bin out as one chunk of plane rows (copies of the JAX
    package's functions, which cannot be imported without jax);
  * per-frame prep (plain torch): ``chunk_order``, ``shared_rows_res``,
    ``_scene_exit_T`` and ``_order_boxes``
    (pool order's boxes are kept per scene);
  * the walks: ``nearest_hit``, ``occluded``, ``nearest_hit_transparent``
    and ``occluded_transparent`` launch the hand-written CUDA kernels
    (``ntracer_tpu_torch/csrc/nearest_hit.cu``, ``occluded.cu``,
    ``nearest_hit_transparent.cu``, ``occluded_transparent.cu``) on CUDA
    tensors and take their plain twins (``*_ref``) on CPU tensors.

The walk visits chunks by the TPU kernel's rule (``_nearest_walk_live``): per
512-ray block, the next four candidate chunks (in visit order, whose
min-over-rays slab entry is below the block's largest best t) are picked
with the bound from *before* the previous group's updates, then visited.
Within a chunk a ray keeps its best hit on strict ``<`` and the lowest lane
wins a tie.  Both versions keep that rule and the same float operations in
the same order (no FMA contraction), so they agree bit for bit.

The occlusion walk (``_occlusion_walk`` of the TPU kernel) answers "is there
any opaque hit with 0 < t < ldist" per ray.  Its bound is the largest
``ldist`` among the block's rays that are not blocked yet, and its groups of
four are picked the same way.  ``blocked`` is a monotone OR over visits, so
any superset of the necessary chunks gives the same answer.

Pools with transparent slots (an opacity row ``opa`` beside the layouts, see
``add_opacity``) take the transparent walks.  ``nearest_hit_transparent``
keeps, beside the nearest opaque hit, the K nearest transparent hits in K
slots per ray: per visited chunk the chunk's transparent hits are taken in
ascending t (lowest lane first on a tie), at most K of them, and each
replaces the first largest slot when it is nearer.  Which slot a hit lands
in depends on the visit set, and the stable sort downstream composes
exactly tied surfaces in slot order, so this walk picks ONE candidate per
step (with the bound from before the current visit) exactly as the TPU
kernel does, and slot positions are part of the contract between kernel and
twin.  ``occluded_transparent`` is the occlusion walk with a second output,
``filt``: the product of (1 - opacity) over the transparent hits with
t < ldist, multiplied per visited chunk as a halving tree over the 128
lanes (lanes i and i + 64, then i and i + 32, ...), which is the TPU
kernel's association; ``filt`` is 1 where ``blocked``.

Each walk takes a pool of any size.  On the card every walk copies each
visited chunk into a ring of slots in shared memory while the previous one
is tested (the streaming loop, ``csrc/stream_walk.cuh``), so one CUDA body
serves what the JAX package splits at its line (``STREAM_POOL_BYTES``)
into a resident and a streaming kernel: ``nearest_hit`` stands for kernels
2.1 and 2.5, ``occluded`` for 2.2 and 2.6, ``occluded_transparent`` for
2.4 and 2.8.  The line still decides one thing, as the TPU kernels do: over
it the K-slot walk picks its candidates in groups of four
(``nearest_hit_transparent_hbm``, 2.7) where under it it picks one
(``nearest_hit_transparent``, 2.3, the same body in groups of one), so its
slot positions (and visits) may differ on the same inputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import graphs

RAY_BLOCK = 512   # rays per walk block: one 32x16-pixel tile
CK = 128          # triangle slots per chunk
C_PAD = 8         # coordinate rows padded to 8 (d <= 8)

ROUNDING_FUZZ = np.float32(np.finfo(np.float32).eps * 10)
INF = np.float32(np.inf)
BIG = np.float32(3e37)
ONE_FUZZ = float(np.float32(1) + ROUNDING_FUZZ)
EXIT_SCALE = float(np.float32(1) + np.float32(16) * ROUNDING_FUZZ)

# candidate chunks picked per walk step (the TPU kernel's P_CAND)
P_CAND = 4
# Pools whose layouts (``pool_bytes``) take more than this take the K-slot
# walk's grouped rule (``nearest_hit_transparent_hbm``), where the JAX
# package streams their visited chunks.  It equals the JAX package's line
# (``POOL_VMEM_BUDGET``, counted by ``pool_vmem_bytes``), so both packages
# take the streaming walks on the same scenes, and for glass the same visit
# rule; on the H100 it sits just under the 50 MB L2, which a larger pool no
# longer fits in.
STREAM_POOL_BYTES = 48 * 1024 * 1024
# Elements of the largest slab a twin makes at once, on the card and on the
# CPU: (blocks, 512, n_eff) entry bounds or (blocks, 512, 128) pair tests
# (``_twin_step``)
TWIN_SLAB = {"cuda": 1 << 29, "cpu": 1 << 20}
# transparent slots a ray can hold in the CUDA kernel (registers per thread)
MAX_K = 8
SENT = 1 << 30    # "no candidate" position


def _pad8(n):
    return -(-n // 8) * 8


def pool_bytes(n_tris, d, ck: int = CK):
    """Bytes of a pool's layouts as the JAX package counts them
    (``pool_vmem_bytes``): ``ceil(n_tris / ck)`` chunks of padded plane
    rows, offset rows and id rows, no opacity row."""
    nc = -(-n_tris // ck)
    return nc * (_pad8(d * d) * ck + 2 * C_PAD * ck) * 4


def _check_k(K):
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the transparent walk holds 1..{MAX_K} slots a "
                         f"ray, not K={K}")


# ---------------------------------------------------------------------------
# Host prep (numpy, once per scene)
# ---------------------------------------------------------------------------

def prepare_resident_cells(treelets, tri_p1, tri_fn, tri_en, tri_dc,
                           tri_lo, tri_hi, d, ck: int = CK, tri_mat=None):
    """Chunk layouts from bins of pool ids: one chunk per bin, chunk AABB =
    content box clipped to the bin's cell, ``ids`` mapping slots back to
    pool ids.

    Returns numpy arrays:
      ``gt``   (nc, pad8(d*d), ck) -- plane rows, plane-major: row p*d+c =
               coordinate c of plane p's normal (plane 0 = face normal);
      ``ci``   (nc, 8, ck)  -- row 0 = -dc, rows 1..d-1 = edge offsets;
      ``ids``  (nc, 8, ck) i32 -- row 0 pool id (-2 for empty slots),
               row 1 material id;
      ``klo``/``khi`` (nc, d) chunk AABBs, ``b_lo``/``b_hi`` (d,) pool AABB,
      ``n_eff`` (1,) i32 and ``base_order`` (nc,) i32."""
    nc = len(treelets)
    pr = _pad8(d * d)
    gt = np.zeros((nc, pr, ck), np.float32)
    ci = np.zeros((nc, C_PAD, ck), np.float32)
    ids = np.full((nc, C_PAD, ck), -2, np.int32)  # -2 never matches a skip
    klo = np.full((max(nc, 1), d), BIG, np.float32)
    khi = np.full((max(nc, 1), d), -BIG, np.float32)

    planes = np.concatenate([tri_fn[:, None, :], tri_en], axis=1)  # (T,d,d)
    eo = np.einsum("tid,td->ti", tri_en, tri_p1, dtype=np.float32)

    for k, (cl, ch, pids) in enumerate(treelets):
        pids = np.asarray(pids, np.int64)
        n = len(pids)
        # gt[k, p*d + c, s] = planes[pids[s], p, c]
        gt[k, :d * d, :n] = planes[pids].reshape(n, d * d).T
        ci[k, 0, :n] = -tri_dc[pids]
        ci[k, 1:d, :n] = eo[pids].T
        ids[k, 0, :n] = pids
        if tri_mat is not None:
            ids[k, 1, :n] = np.asarray(tri_mat, np.int32)[pids]
        klo[k] = np.maximum(tri_lo[pids].min(axis=0), cl)
        khi[k] = np.minimum(tri_hi[pids].max(axis=0), ch)

    fn_norm = np.linalg.norm(tri_fn, axis=1)
    real = fn_norm > 0
    if real.any():
        b_lo = tri_lo[real].min(axis=0)
        b_hi = tri_hi[real].max(axis=0)
    else:
        b_lo = np.zeros(d, np.float32)
        b_hi = np.zeros(d, np.float32)
    return dict(gt=gt, ci=ci, ids=ids, klo=klo, khi=khi, b_lo=b_lo,
                b_hi=b_hi, n_eff=np.asarray([nc], np.int32),
                base_order=np.arange(max(nc, 1), dtype=np.int32))


def add_opacity(res, tri_opacity, ck: int = CK):
    """Attach the per-slot opacity row ``opa`` (nc, 8, ck) the transparent
    walks read (row 0); padding slots get opacity 1 (their zero face normal
    already kills hits)."""
    ids = res["ids"][:, 0, :]
    safe = np.clip(ids, 0, len(tri_opacity) - 1)
    opa = np.ones((ids.shape[0], C_PAD, ck), np.float32)
    opa[:, 0, :] = np.where(ids >= 0, tri_opacity[safe], 1.0)
    res["opa"] = opa
    return res


def centroid_bins(tri_lo, tri_hi, fn_norm, ck: int):
    """Partition real triangles (non-degenerate AABBs) into spatial bins of
    <= ck by recursive median split on the widest centroid axis.  Every
    triangle lands in exactly ONE bin; bin boxes are the exact union of
    member AABBs.

    Returns a list of (lo, hi, [pool ids]) for prepare_resident_cells (the
    clip box is the content box itself)."""
    ids_all = np.nonzero(fn_norm > 0)[0]
    if len(ids_all) == 0:
        return []
    cent = (tri_lo + tri_hi) * 0.5
    out = []

    def rec(ids):
        if len(ids) <= ck:
            lo = tri_lo[ids].min(axis=0)
            hi = tri_hi[ids].max(axis=0)
            out.append((lo, hi, list(ids)))
            return
        c = cent[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        h = len(ids) // 2
        rec(ids[order[:h]])
        rec(ids[order[h:]])

    # primitives whose box spans a large fraction of the scene (sliver
    # batches, walls) would drag any spatial bin's box out to near-global
    # and destroy the culling; give them dedicated always-visited bins
    diag = np.linalg.norm(tri_hi[ids_all] - tri_lo[ids_all], axis=1)
    scene_diag = np.linalg.norm(tri_hi[ids_all].max(axis=0)
                                - tri_lo[ids_all].min(axis=0))
    wide = diag > 0.35 * max(scene_diag, 1e-30)
    for s in range(0, int(wide.sum()), ck):
        ids = ids_all[wide][s:s + ck]
        out.append((tri_lo[ids].min(axis=0), tri_hi[ids].max(axis=0),
                    list(ids)))
    narrow = ids_all[~wide]
    if len(narrow):
        rec(narrow)
    return out


# ---------------------------------------------------------------------------
# Per-frame prep (plain torch)
# ---------------------------------------------------------------------------

def _sum_rows(v):
    """Sum over axis 0, left to right (one rounding per add)."""
    acc = v[0]
    for i in range(1, v.shape[0]):
        acc = acc + v[i]
    return acc


def _sqrt(x):
    """Correctly rounded float32 square root, the same on every device.

    torch's vectorized CPU sqrt is not correctly rounded (about 0.7% of
    float32 results are one ulp off, and its float64 sqrt can be too), and
    whether an element takes the vectorized path depends on how the op is
    split across threads.  So the float64 root is rounded and then
    corrected: the midpoints between neighbouring float32 values square
    exactly in float64, so comparing their squares with ``x`` picks the
    correctly rounded neighbour."""
    xd = x.double()
    s = torch.sqrt(xd).to(torch.float32)
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    dn = torch.nextafter(s, torch.zeros_like(s))
    sd = s.double()
    mid_up = (sd + up.double()) * 0.5
    mid_dn = (sd + dn.double()) * 0.5
    s = torch.where(mid_up * mid_up < xd, up,
                    torch.where(mid_dn * mid_dn > xd, dn, s))
    return torch.where((xd > 0) & torch.isfinite(xd), s,
                       torch.sqrt(xd).to(torch.float32))


def chunk_order(klo, khi, origin):
    """Front-to-back chunk permutation + per-position distance lower bounds
    from the shared ray origin ``origin`` (d,).  Returns (order (nc,) i32,
    dmin (nc,) f32); empty chunks (inverted boxes) sort last with BIG.
    The sort is stable, so chunks at equal distance keep pool order."""
    span_ok = klo <= khi
    cl = torch.minimum(klo, khi)
    ch = torch.maximum(klo, khi)
    p = torch.minimum(torch.maximum(origin[None, :], cl), ch)
    dv = torch.where(span_ok, p - origin[None, :], 0.0)
    dist = _sqrt(_sum_rows((dv * dv).T))
    dist = torch.where(torch.all(span_ok, dim=1), dist, float(BIG))
    dmin, order = torch.sort(dist, stable=True)
    return order.to(torch.int32), dmin


def _scene_exit_T(oT, dT, b_lo, b_hi):
    """Exit distance of each ray from the pool AABB, scaled by
    (1 + 16 fuzz); 0 when the box is missed.  (d, R) rays -> (R,)."""
    par = dT == 0
    inv = torch.where(par, 0.0, 1.0 / torch.where(par, 1.0, dT))
    a = (b_lo[:, None] - oT) * inv
    b = (b_hi[:, None] - oT) * inv
    inside = (oT >= b_lo[:, None]) & (oT <= b_hi[:, None])
    big = float(BIG)
    t0 = torch.where(par, torch.where(inside, -big, big), torch.minimum(a, b))
    t1 = torch.where(par, torch.where(inside, big, -big), torch.maximum(a, b))
    tn = torch.amax(t0, dim=0)
    tf = torch.amin(t1, dim=0)
    hit = (tf >= torch.clamp(tn, min=0.0)) & (tf >= 0)
    return torch.where(hit, tf * EXIT_SCALE, 0.0)


def shared_rows_res(gt, ci, origin, d):
    """Shared-origin rows ``sh[k, p, s] = ci[k, p, s] - o . n_p`` with the
    origin dots accumulated coordinate by coordinate -- the per-ray walk's
    float ops, computed once per frame.  Returns (nc, C_PAD, ck)."""
    nc, _pr, ck = gt.shape
    sh = torch.zeros((nc, C_PAD, ck), dtype=torch.float32, device=gt.device)
    for p in range(d):
        acc = torch.zeros((nc, ck), dtype=torch.float32, device=gt.device)
        for c in range(d):
            acc = acc + origin[c] * gt[:, p * d + c, :]
        sh[:, p, :] = ci[:, p, :] - acc
    return sh


def _order_boxes(res, order, d):
    """Chunk boxes permuted into visit order and transposed to
    (C_PAD, ncp); padding positions get inverted boxes."""
    nc = res["klo"].shape[0]
    ncp = -(-nc // 128) * 128
    dev = res["klo"].device
    klo_t = torch.full((C_PAD, ncp), float(BIG), dtype=torch.float32,
                       device=dev)
    khi_t = torch.full((C_PAD, ncp), -float(BIG), dtype=torch.float32,
                       device=dev)
    klo_t[:d, :nc] = res["klo"][order.long()].T
    khi_t[:d, :nc] = res["khi"][order.long()].T
    return klo_t, khi_t


def _visit_boxes(res, order, d):
    """(order, klo_t, khi_t) of a walk.  Without an ``order`` the walk goes
    in pool order, whose boxes ``res["base_boxes"]`` holds where the scene's
    tensors were made once (wavefront.tensors_from_arrays)."""
    if order is not None:
        return (order, *_order_boxes(res, order, d))
    boxes = res.get("base_boxes")
    if boxes is None:
        boxes = _order_boxes(res, res["base_order"], d)
    return (res["base_order"], *boxes)


def _walk_inputs(res, oT, dT, skip, d, order, active, sh, K=0):
    """Inputs shared by the kernel and its twin: the walk's start distance
    (scene exit, 0 for inactive rays), per-block liveness and the chunk
    boxes in visit order.  ``K`` > 0 selects the transparent walk (K slots
    a ray, the pool's opacity row)."""
    if K and res.get("opa") is None:
        raise ValueError("the transparent walk needs the pool's opacity row "
                         "(add_opacity)")
    R = oT.shape[1]
    if R % RAY_BLOCK:
        raise ValueError(f"ray count {R} is not a multiple of {RAY_BLOCK}")
    init_t = _scene_exit_T(oT, dT, res["b_lo"], res["b_hi"])
    if active is not None:
        init_t = torch.where(active, init_t, 0.0)
    order, klo_t, khi_t = _visit_boxes(res, order, d)
    blive = (torch.amax(init_t.reshape(-1, RAY_BLOCK), dim=1) > 0) \
        .to(torch.int32)
    return dict(d=d, shared=sh is not None, oT=oT, dT=dT, skip=skip,
                init_t=init_t, order=order, n_eff=int(res["n_eff"]),
                blive=blive, klo_t=klo_t, khi_t=khi_t, gt=res["gt"],
                ci=res["ci"] if sh is None else sh, ids=res["ids"], K=K,
                opa=res.get("opa") if K else None)


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------

def _entry_all(d, o, dv, klo_t, khi_t, n):
    """Slab entry of every (ray, chunk position < n): (nb, RB, n), INF for
    missed chunks.  ``o``/``dv`` are (d, nb, RB, 1)."""
    big = float(BIG)
    tn = torch.full((1,), -big, dtype=torch.float32, device=o.device)
    tf = torch.full((1,), big, dtype=torch.float32, device=o.device)
    for c in range(d):
        lo = klo_t[c, :n]
        hi = khi_t[c, :n]
        oc = o[c]
        dc = dv[c]
        par = dc == 0
        inv = torch.where(par, 0.0, 1.0 / torch.where(par, 1.0, dc))
        a = (lo - oc) * inv
        b = (hi - oc) * inv
        ins = (oc >= lo) & (oc <= hi)
        t0 = torch.where(par, torch.where(ins, -big, big),
                         torch.minimum(a, b))
        t1 = torch.where(par, torch.where(ins, big, -big),
                         torch.maximum(a, b))
        tn = torch.maximum(tn, t0)
        tf = torch.minimum(tf, t1)
    entry = torch.clamp(tn, min=0.0)
    ok = (tf >= entry) & (tf >= 0)
    return torch.where(ok, entry, float(INF))


def _entry_minima(w, o, dv):
    """Block minima of the slab entries, (nb, n_eff), for the blocks of
    ``o``/``dv`` (d, nb, RB, 1), in steps of blocks whose (blocks, 512,
    n_eff) slab stays within ``TWIN_SLAB``."""
    n, nb = w["n_eff"], o.shape[1]
    step = _twin_step(n, o.device.type)
    return torch.cat([
        torch.amin(_entry_all(w["d"], o[:, b:b + step], dv[:, b:b + step],
                              w["klo_t"], w["khi_t"], n), dim=1)
        for b in range(0, nb, step)])


def _chunk_hits_vals(d, shared, g, ci, idrow, o, dv, skip):
    """Ray-block x chunk pair test (tracer.hpp:411-440): (n, RB, CK) t and
    valid for ``n`` blocks, each against its own chunk.  ``g`` (n, pr, CK),
    ``ci`` (n, 8, CK), ``idrow`` (n, CK); ``o``/``dv`` (d, n, RB, 1), ``skip``
    (n, RB, 1).  Plane dots accumulate coordinate by coordinate."""
    zeros = torch.zeros((1,), dtype=torch.float32, device=g.device)

    def dots(p):
        acc_o = None if shared else zeros
        acc_d = zeros
        for c in range(d):
            row = g[:, None, p * d + c, :]                # (n, 1, CK)
            if not shared:
                acc_o = acc_o + o[c] * row
            acc_d = acc_d + dv[c] * row
        return acc_o, acc_d

    o0, denom = dots(0)
    if shared:
        t = ci[:, None, 0, :] / denom
    else:
        t = (ci[:, None, 0, :] - o0) / denom
    valid = (denom != 0) & (t > 0)
    tot = zeros
    for i in range(1, d):
        oi, di = dots(i)
        if shared:
            a = ci[:, None, i, :] - t * di
        else:
            a = ci[:, None, i, :] - oi - t * di
        valid &= (a >= -ROUNDING_FUZZ) & (a <= ONE_FUZZ)
        tot = tot + a
    valid &= tot <= ONE_FUZZ
    valid &= idrow[:, None, :] != skip
    return t, valid


def _find_cands(emin, bound, k0, n, p=P_CAND):
    """Positions of the next ``p`` chunks >= k0 whose entry bound is below
    the block's bound: (nb, p), SENT fills."""
    posi = torch.arange(n, dtype=torch.int64, device=emin.device)
    cand = (emin < bound[:, None]) & (posi[None, :] >= k0[:, None])
    cp = torch.where(cand, posi[None, :], SENT)
    if n < p:
        cp = torch.cat([cp, torch.full((cp.shape[0], p - n), SENT,
                                       dtype=cp.dtype, device=cp.device)], 1)
    return torch.topk(cp, p, dim=1, largest=False, sorted=True).values


def _first_where(v, target, n):
    """Lowest index along the last axis where ``v`` equals ``target``
    (..., 1); ``n`` = the axis length.  Ties resolve to the first index on
    every device."""
    idx = torch.arange(n, dtype=torch.int64, device=v.device)
    return torch.amin(torch.where(v == target, idx, n), dim=-1)


def _insert_transparent(tt, tid, tmt, base, K):
    """Offer one chunk's transparent hits to the K slots: the chunk's hits
    in ascending t (lowest lane first on a tie), at most K of them, each
    replacing the FIRST largest slot when it is nearer.  ``tt``/``tid``
    (n, RB, K), ``tmt`` (n, RB, CK) hit distances (INF where there is none),
    ``base`` (n, 1) the chunk's first slot id."""
    inf = float(INF)
    for _s in range(K):
        st = torch.amin(tmt, dim=2, keepdim=True)
        if not bool((st < inf).any()):
            break                       # nothing left: no slot would change
        sarg = _first_where(tmt, st, CK)
        tmt = tmt.scatter(2, sarg[:, :, None], inf)
        bmax = torch.amax(tt, dim=2, keepdim=True)
        barg = _first_where(tt, bmax, K)
        lanes = torch.arange(K, dtype=torch.int64, device=tt.device)
        put = (st < bmax) & (lanes == barg[:, :, None])
        tid = torch.where(put, (base + sarg)[:, :, None], tid)
        tt = torch.where(put, st, tt)
    return tt, tid


def _walk_blocks(w, b0, b1):
    """Twin walk of ray blocks [b0, b1), vectorized over blocks.  With
    ``w["K"]`` slots it is the transparent walk: one candidate a step
    (``P_CAND`` with ``w["grouped"]``, the streaming walk's rule), opaque
    slots compete for the nearest hit and transparent ones go to the K
    slots.  Returns (best, best_id, visits, tt, tid, replaced);
    ``tt``/``tid`` are (nb, RB, K) (K = 0: empty), ``replaced`` counts the
    filled slots that a nearer hit took over on the way."""
    d, shared, n, K = w["d"], w["shared"], w["n_eff"], w["K"]
    p = 1 if K and not w.get("grouped") else P_CAND
    nb = b1 - b0
    sl = slice(b0 * RAY_BLOCK, b1 * RAY_BLOCK)
    dev = w["oT"].device

    def blocks(x):                      # (k, R) slice -> (k, nb, RB, 1)
        return x[:, sl].reshape(x.shape[0], nb, RAY_BLOCK, 1)

    o = blocks(w["oT"])
    dv = blocks(w["dT"])
    skip = w["skip"][sl].reshape(nb, RAY_BLOCK, 1)
    best = w["init_t"][sl].reshape(nb, RAY_BLOCK).clone()
    best_id = torch.full((nb, RAY_BLOCK), -1, dtype=torch.int64, device=dev)
    tt = torch.full((nb, RAY_BLOCK, K), float(INF), dtype=torch.float32,
                    device=dev)
    tid = torch.full((nb, RAY_BLOCK, K), -1, dtype=torch.int64, device=dev)
    visits = torch.zeros((nb,), dtype=torch.int32, device=dev)
    replaced = torch.zeros((), dtype=torch.int64, device=dev)
    live_blk = w["blive"][b0:b1] != 0
    if n == 0:
        return best, best_id, visits, tt, tid, replaced

    emin = _entry_minima(w, o, dv)                      # (nb, n)
    order = w["order"].long()
    none = torch.full((nb,), n, dtype=torch.int64, device=dev)
    cur = _find_cands(emin, torch.amax(best, dim=1),
                      torch.zeros_like(none), n, p)
    cur[~live_blk] = SENT
    while bool((cur[:, 0] < SENT).any()):
        # the next group is picked with the bound from before this group
        k0 = torch.where(cur[:, -1] < SENT, cur[:, -1] + 1, none)
        nxt = _find_cands(emin, torch.amax(best, dim=1), k0, n, p)
        for j in range(p):
            sel = torch.nonzero(cur[:, j] < SENT).squeeze(1)
            if sel.numel() == 0:
                continue
            idx = order[cur[sel, j]]
            t, valid = _chunk_hits_vals(
                d, shared, w["gt"][idx], w["ci"][idx], w["ids"][idx, 0],
                o[:, sel], dv[:, sel], skip[sel])
            if K:
                opaq = w["opa"][idx, 0][:, None, :] >= 1.0
                tmt = torch.where(valid & ~opaq, t, float(INF))
                valid = valid & opaq
            tm = torch.where(valid, t, float(INF))
            ct, carg = torch.min(tm, dim=2)
            upd = ct < best[sel]
            best_id[sel] = torch.where(upd, idx[:, None] * CK + carg,
                                       best_id[sel])
            best[sel] = torch.where(upd, ct, best[sel])
            if K:
                was = tid[sel]
                tt[sel], tid[sel] = _insert_transparent(
                    tt[sel], was, tmt, idx[:, None] * CK, K)
                replaced += ((was >= 0) & (tid[sel] != was)).sum()
            visits[sel] += 1
        cur = nxt
    return best, best_id, visits, tt, tid, replaced


def _twin_step(width, device_type):
    """Blocks a twin takes together: as many as keep a (blocks, 512,
    width) slab within ``TWIN_SLAB`` elements, at least one.  The entry
    pass steps with width n_eff (the entry bounds of every chunk position),
    the walk with width 128 (one chunk's pair tests).  Outputs do not depend
    on either step: blocks walk independently."""
    kind = "cuda" if device_type == "cuda" else "cpu"
    return max(1, TWIN_SLAB[kind] // (RAY_BLOCK * max(width, 1)))


def _walk_ref(w):
    """(t, slot, visits), and with ``w["K"]`` slots (t, slot, tt (K, R),
    tslot (K, R), visits); the count of replaced slots is left in
    ``w["replaced"]``."""
    nb = w["oT"].shape[1] // RAY_BLOCK
    K = w["K"]
    step = _twin_step(CK, w["oT"].device.type)
    ts, ids, vis, tts, tids = [], [], [], [], []
    w["replaced"] = 0
    for b0 in range(0, nb, step):
        t, i, v, tt, tid, rep = _walk_blocks(w, b0, min(nb, b0 + step))
        w["replaced"] += int(rep)
        ts.append(t.reshape(-1))
        ids.append(i.reshape(-1))
        vis.append(v)
        tts.append(tt.flatten(0, 1))
        tids.append(tid.flatten(0, 1))
    t, slot, vis = (torch.cat(ts), torch.cat(ids).to(torch.int32),
                    torch.cat(vis))
    if not K:
        return t, slot, vis
    return (t, slot, torch.cat(tts).T.contiguous(),
            torch.cat(tids).to(torch.int32).T.contiguous(), vis)


def nearest_hit_ref(res, oT, dT, skip, d, order=None, active=None, sh=None):
    """Plain-torch twin of ``nearest_hit``: the same walk, the same visit
    rule and the same float operations, over (blocks, 512, 128) slabs."""
    return _walk_ref(_walk_inputs(res, oT, dT, skip, d, order, active, sh))


def nearest_hit_transparent_ref(res, oT, dT, skip, d, K, order=None,
                                active=None, sh=None):
    """Plain-torch twin of ``nearest_hit_transparent``: the same walk (one
    candidate a step), the same float operations and the same slot
    assignment, over (blocks, 512, 128) slabs.  After a call its attribute
    ``replaced`` says how many filled slots a nearer hit took over (a ray
    that crosses more glass than it has slots)."""
    _check_k(K)
    w = _walk_inputs(res, oT, dT, skip, d, order, active, sh, K=K)
    out = _walk_ref(w)
    nearest_hit_transparent_ref.replaced = w["replaced"]
    return out


nearest_hit_transparent_ref.replaced = 0


def nearest_hit_transparent_hbm_ref(res, oT, dT, skip, d, K, order=None,
                                    active=None, sh=None):
    """Plain-torch twin of ``nearest_hit_transparent_hbm``: the K-slot walk
    of ``nearest_hit_transparent_ref`` with the grouped rule of pools over
    the line (four candidates a step, picked with the bound from before the
    previous group).  ``replaced`` as there."""
    _check_k(K)
    w = _walk_inputs(res, oT, dT, skip, d, order, active, sh, K=K)
    w["grouped"] = True
    out = _walk_ref(w)
    nearest_hit_transparent_hbm_ref.replaced = w["replaced"]
    return out


nearest_hit_transparent_hbm_ref.replaced = 0


def _occlusion_inputs(res, oT, dT, ldist, skip, d, order, filtered=False):
    """Inputs shared by the occlusion kernels and their twins: per-block
    liveness (any ray with ``ldist > 0``) and the chunk boxes in visit
    order.  ``filtered`` selects the transparent walk (the pool's opacity
    row)."""
    if filtered and res.get("opa") is None:
        raise ValueError("the transparent walk needs the pool's opacity row "
                         "(add_opacity)")
    R = oT.shape[1]
    if R % RAY_BLOCK:
        raise ValueError(f"ray count {R} is not a multiple of {RAY_BLOCK}")
    order, klo_t, khi_t = _visit_boxes(res, order, d)
    blive = (torch.amax(ldist.reshape(-1, RAY_BLOCK), dim=1) > 0) \
        .to(torch.int32)
    return dict(d=d, oT=oT, dT=dT, skip=skip, ldist=ldist, order=order,
                n_eff=int(res["n_eff"]), blive=blive, klo_t=klo_t,
                khi_t=khi_t, gt=res["gt"], ci=res["ci"], ids=res["ids"],
                opa=res.get("opa") if filtered else None)


def _lane_tree_product(v):
    """Product over the last axis (a power of two long) as a halving tree:
    entries i and i + w/2, then i and i + w/4, ...  Three or more factors
    other than 1 round differently under another association."""
    w = v.shape[-1]
    while w > 1:
        w //= 2
        v = v[..., :w] * v[..., w:2 * w]
    return v[..., 0]


def _occlusion_blocks(w, b0, b1):
    """Twin occlusion walk of ray blocks [b0, b1), vectorized over blocks.
    Returns (blocked, filt, visits); with an opacity row only opaque slots
    block and ``filt`` gathers the transparent ones, else ``filt`` is 1."""
    d, n = w["d"], w["n_eff"]
    nb = b1 - b0
    sl = slice(b0 * RAY_BLOCK, b1 * RAY_BLOCK)
    dev = w["oT"].device

    def blocks(x):                      # (k, R) slice -> (k, nb, RB, 1)
        return x[:, sl].reshape(x.shape[0], nb, RAY_BLOCK, 1)

    o = blocks(w["oT"])
    dv = blocks(w["dT"])
    skip = w["skip"][sl].reshape(nb, RAY_BLOCK, 1)
    ldist = w["ldist"][sl].reshape(nb, RAY_BLOCK)
    blocked = torch.zeros((nb, RAY_BLOCK), dtype=torch.bool, device=dev)
    filt = torch.ones((nb, RAY_BLOCK), dtype=torch.float32, device=dev)
    visits = torch.zeros((nb,), dtype=torch.int32, device=dev)
    live_blk = w["blive"][b0:b1] != 0
    if n == 0:
        return blocked, filt, visits

    def lmax():                         # largest ldist of the unblocked rays
        return torch.amax(torch.where(blocked, 0.0, ldist), dim=1)

    emin = _entry_minima(w, o, dv)                      # (nb, n)
    order = w["order"].long()
    none = torch.full((nb,), n, dtype=torch.int64, device=dev)
    cur = _find_cands(emin, lmax(), torch.zeros_like(none), n)
    cur[~live_blk] = SENT
    while bool((cur[:, 0] < SENT).any()):
        # the next group is picked with the bound from before this group
        k0 = torch.where(cur[:, -1] < SENT, cur[:, -1] + 1, none)
        nxt = _find_cands(emin, lmax(), k0, n)
        for j in range(P_CAND):
            sel = torch.nonzero(cur[:, j] < SENT).squeeze(1)
            if sel.numel() == 0:
                continue
            idx = order[cur[sel, j]]
            t, valid = _chunk_hits_vals(
                d, False, w["gt"][idx], w["ci"][idx], w["ids"][idx, 0],
                o[:, sel], dv[:, sel], skip[sel])
            valid &= t < ldist[sel][:, :, None]
            if w["opa"] is not None:
                op = w["opa"][idx, 0][:, None, :]
                opaq = op >= 1.0
                filt[sel] = filt[sel] * _lane_tree_product(
                    torch.where(valid & ~opaq, 1.0 - op, 1.0))
                valid = valid & opaq
            blocked[sel] |= torch.any(valid, dim=2)
            visits[sel] += 1
        cur = nxt
    return blocked, torch.where(blocked, 1.0, filt), visits


def _occlusion_ref(w):
    nb = w["oT"].shape[1] // RAY_BLOCK
    step = _twin_step(CK, w["oT"].device.type)
    bl, fl, vis = [], [], []
    for b0 in range(0, nb, step):
        b, f, v = _occlusion_blocks(w, b0, min(nb, b0 + step))
        bl.append(b.reshape(-1))
        fl.append(f.reshape(-1))
        vis.append(v)
    return torch.cat(bl), torch.cat(fl), torch.cat(vis)


def occluded_ref(res, oT, dT, ldist, skip, d, order=None):
    """Plain-torch twin of ``occluded``: the same walk, the same visit rule
    and the same float operations, over (blocks, 512, 128) slabs."""
    blocked, _filt, vis = _occlusion_ref(
        _occlusion_inputs(res, oT, dT, ldist, skip, d, order))
    return blocked, vis


def occluded_transparent_ref(res, oT, dT, ldist, skip, d, order=None):
    """Plain-torch twin of ``occluded_transparent``: the occlusion walk with
    the opacity row, ``filt`` multiplied per visit as the halving tree."""
    return _occlusion_ref(
        _occlusion_inputs(res, oT, dT, ldist, skip, d, order, filtered=True))


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_walk(w, dev):
    """Check what both kernels take: the pool layout and the ray tensors.
    Returns (R, blocks, plane rows, ncp, n_eff)."""
    d = w["d"]
    R = w["oT"].shape[1]
    nc, pr, ck = w["gt"].shape
    n = w["n_eff"]
    if not 3 <= d <= C_PAD or ck != CK or pr != _pad8(d * d):
        raise ValueError(f"unsupported pool layout {tuple(w['gt'].shape)} "
                         f"for d={d}")
    if not 0 <= n <= nc:
        raise ValueError(f"n_eff={n} outside [0, {nc}]")
    f32, i32 = torch.float32, torch.int32
    _check("oT", w["oT"], f32, (d, R), dev)
    _check("dT", w["dT"], f32, (d, R), dev)
    _check("skip", w["skip"], i32, (R,), dev)
    _check("order", w["order"], i32, (nc,), dev)
    _check("gt", w["gt"], f32, (nc, pr, CK), dev)
    _check("ci", w["ci"], f32, (nc, C_PAD, CK), dev)
    _check("ids", w["ids"], i32, (nc, C_PAD, CK), dev)
    if w["opa"] is not None:
        _check("opa", w["opa"], f32, (nc, C_PAD, CK), dev)
    return R, R // RAY_BLOCK, pr, w["klo_t"].shape[1], n


def _device(name, dev):
    """Whether a wrapper takes its twin (CPU tensors) or its kernel (CUDA
    tensors); any other device raises."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return True


def _check_stream(w):
    """Every chunk walk's kernel fills a ring of chunk slots by TMA bulk
    copies, each piece of a chunk as one 16-byte aligned range."""
    for k in ("gt", "ci", "ids", "opa"):
        if w[k] is not None and w[k].data_ptr() % 16:
            raise ValueError(f"{k} is not 16-byte aligned")


def _launched(name, fn, err):
    if err:
        from . import _build
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_build.error_string(err)} ({err})")
    fn.launches += 1


def _nearest_kernel(name, w, dev, then=None):
    """Launch the C entry ``name`` (a nearest-hit walk, with ``w["K"]``
    the K-slot one) on the walk inputs ``w`` through ``graphs.launch``
    (which calls ``then(error code)``); returns (error code, its outputs as
    the twin returns them)."""
    from . import _build
    lib = _build.load()
    R, nb, pr, ncp, n = _check_walk(w, dev)
    _check_stream(w)
    f32, i32 = torch.float32, torch.int32
    K = w["K"]
    init_t = w["init_t"].contiguous()
    blive = w["blive"].contiguous()
    out_t = torch.empty((R,), dtype=f32, device=dev)
    out_slot = torch.empty((R,), dtype=i32, device=dev)
    visits = torch.empty((nb,), dtype=i32, device=dev)
    emin = torch.empty((max(nb * n, 1),), dtype=f32, device=dev)
    head = (w["oT"].data_ptr(), w["dT"].data_ptr(), w["skip"].data_ptr(),
            init_t.data_ptr(), w["order"].data_ptr(), n, blive.data_ptr(),
            w["klo_t"].data_ptr(), w["khi_t"].data_ptr(), ncp,
            w["gt"].data_ptr(), w["ci"].data_ptr(), w["ids"].data_ptr())
    keep = (w, init_t, blive, out_t, out_slot, visits, emin)
    if not K:
        err = graphs.launch(getattr(lib, name), (
            *head, pr, R, w["d"], int(w["shared"]), out_t.data_ptr(),
            out_slot.data_ptr(), visits.data_ptr(), emin.data_ptr()),
            dev, keep, then)
        return err, (out_t, out_slot, visits)
    out_tt = torch.empty((K, R), dtype=f32, device=dev)
    out_tslot = torch.empty((K, R), dtype=i32, device=dev)
    err = graphs.launch(getattr(lib, name), (
        *head, w["opa"].data_ptr(), pr, R, w["d"], int(w["shared"]), K,
        out_t.data_ptr(), out_slot.data_ptr(), out_tt.data_ptr(),
        out_tslot.data_ptr(), visits.data_ptr(), emin.data_ptr()),
        dev, (*keep, out_tt, out_tslot), then)
    return err, (out_t, out_slot, out_tt, out_tslot, visits)


def _occlusion_kernel(name, w, dev, then=None):
    """Launch the C entry ``name`` (an occlusion walk, with ``w["opa"]``
    the filtered one) on the walk inputs ``w`` through ``graphs.launch``
    (which calls ``then(error code)``); returns (error code, its outputs as
    the twin returns them)."""
    from . import _build
    lib = _build.load()
    R, nb, pr, ncp, n = _check_walk(w, dev)
    _check("ldist", w["ldist"], torch.float32, (R,), dev)
    _check_stream(w)
    blive = w["blive"].contiguous()
    blocked = torch.empty((R,), dtype=torch.bool, device=dev)
    visits = torch.empty((nb,), dtype=torch.int32, device=dev)
    emin = torch.empty((max(nb * n, 1),), dtype=torch.float32, device=dev)
    head = (w["oT"].data_ptr(), w["dT"].data_ptr(), w["skip"].data_ptr(),
            w["ldist"].data_ptr(), w["order"].data_ptr(), n,
            blive.data_ptr(), w["klo_t"].data_ptr(), w["khi_t"].data_ptr(),
            ncp, w["gt"].data_ptr(), w["ci"].data_ptr(), w["ids"].data_ptr())
    keep = (w, blive, blocked, visits, emin)
    if w["opa"] is None:
        err = graphs.launch(getattr(lib, name), (
            *head, pr, R, w["d"], blocked.data_ptr(), visits.data_ptr(),
            emin.data_ptr()), dev, keep, then)
        return err, (blocked, visits)
    filt = torch.empty((R,), dtype=torch.float32, device=dev)
    err = graphs.launch(getattr(lib, name), (
        *head, w["opa"].data_ptr(), pr, R, w["d"], blocked.data_ptr(),
        filt.data_ptr(), visits.data_ptr(), emin.data_ptr()),
        dev, (*keep, filt), then)
    return err, (blocked, filt, visits)


def _counted(name, fn):
    """The ``then`` of a wrapper's launch: ``_launched`` for ``fn``."""
    return functools.partial(_launched, name, fn)


def nearest_hit(res, oT, dT, skip, d, order=None, active=None, sh=None):
    """Nearest opaque hit of each ray over the chunked pool.

    ``oT``/``dT`` (d, R) rays, ``skip`` (R,) i32 pool id never hit (or -1).
    ``order`` is the chunk visit order (default pool order), ``active`` (R,)
    bool masks rays out, ``sh`` (from shared_rows_res) selects the
    shared-origin pair test for primary rays.

    Returns (t (R,) f32, slot (R,) i32 = chunk*CK + lane or -1, visits
    (R // RAY_BLOCK,) i32 chunks visited per block).  The pool may be of
    any size (kernels 2.1 and 2.5).  On CUDA tensors the CUDA kernel runs
    (and ``nearest_hit.launches`` counts it), so the pool's rows must be
    16-byte aligned; on CPU tensors the plain twin ``nearest_hit_ref``
    does."""
    w = _walk_inputs(res, oT, dT, skip, d, order, active, sh)
    if not _device("nearest_hit", oT.device):
        return _walk_ref(w)
    _err, out = _nearest_kernel("ntr_nearest_hit", w, oT.device,
                                _counted("nearest_hit", nearest_hit))
    return out


nearest_hit.launches = 0


def occluded(res, oT, dT, ldist, skip, d, order=None):
    """Any opaque hit with 0 < t < ``ldist`` over the chunked pool.

    ``oT``/``dT`` (d, R) rays, ``ldist`` (R,) f32 (<= 0 marks an inactive
    ray), ``skip`` (R,) i32 pool id never hit (or -1), ``order`` the chunk
    visit order (default pool order).

    Returns (blocked (R,) bool, visits (R // RAY_BLOCK,) i32 chunks visited
    per block).  The pool may be of any size (kernels 2.2 and 2.6).  On
    CUDA tensors the CUDA kernel runs (and ``occluded.launches`` counts
    it), so the pool's rows must be 16-byte aligned; on CPU tensors the
    plain twin ``occluded_ref`` does.  A block without an active ray costs
    the kernel one load per ray and no walk."""
    if not _device("occluded", oT.device):
        return occluded_ref(res, oT, dT, ldist, skip, d, order=order)
    w = _occlusion_inputs(res, oT, dT, ldist, skip, d, order)
    _err, out = _occlusion_kernel("ntr_occluded", w, oT.device,
                                  _counted("occluded", occluded))
    return out


occluded.launches = 0


def nearest_hit_transparent(res, oT, dT, skip, d, K, order=None, active=None,
                            sh=None):
    """Nearest opaque hit and the K nearest transparent hits of each ray
    over a chunked pool with an opacity row (``res["opa"]``).

    Arguments as ``nearest_hit``; ``K`` in 1..MAX_K.  Returns (t (R,) f32,
    slot (R,) i32, tt (K, R) f32, tslot (K, R) i32, visits): ``tt``/``tslot``
    are the K slots in the walk's own (unsorted) order, +inf and -1 where
    empty, NOT trimmed by ``t``; slots are chunk*CK + lane.  On CUDA tensors
    the CUDA kernel runs (and ``nearest_hit_transparent.launches`` counts
    it): the body of ``nearest_hit_transparent_hbm``'s in groups of one
    candidate, so the pool's rows must be 16-byte aligned; on CPU tensors
    the plain twin ``nearest_hit_transparent_ref`` does."""
    _check_k(K)
    w = _walk_inputs(res, oT, dT, skip, d, order, active, sh, K=K)
    if not _device("nearest_hit_transparent", oT.device):
        return _walk_ref(w)
    _err, out = _nearest_kernel(
        "ntr_nearest_t", w, oT.device,
        _counted("nearest_hit_transparent", nearest_hit_transparent))
    return out


nearest_hit_transparent.launches = 0


def nearest_hit_transparent_hbm(res, oT, dT, skip, d, K, order=None,
                                active=None, sh=None):
    """``nearest_hit_transparent`` for pools over ``STREAM_POOL_BYTES``,
    with the TPU streaming kernel's grouped rule: four
    candidates a step, picked with the bound from before the previous
    group.  A stale bound may visit more chunks than the one-a-step walk,
    and a far glass hit from such a chunk takes a slot, so slot positions
    (and visits) may differ from ``nearest_hit_transparent``'s; t and the
    opaque slot do not.  Arguments and outputs as there.  On CUDA tensors
    the kernel runs (``nearest_hit_transparent_hbm.launches`` counts it);
    on CPU tensors the twin ``nearest_hit_transparent_hbm_ref`` does."""
    _check_k(K)
    w = _walk_inputs(res, oT, dT, skip, d, order, active, sh, K=K)
    w["grouped"] = True
    if not _device("nearest_hit_transparent_hbm", oT.device):
        return _walk_ref(w)
    _err, out = _nearest_kernel(
        "ntr_nearest_t_hbm", w, oT.device,
        _counted("nearest_hit_transparent_hbm", nearest_hit_transparent_hbm))
    return out


nearest_hit_transparent_hbm.launches = 0


def occluded_transparent(res, oT, dT, ldist, skip, d, order=None):
    """Any opaque hit with 0 < t < ``ldist``, and the light that the
    transparent hits in that range let through, over a chunked pool with an
    opacity row (``res["opa"]``).

    Arguments as ``occluded``.  Returns (blocked (R,) bool, filt (R,) f32,
    visits): ``filt`` is the product of (1 - opacity) over the ray's
    transparent hits with t < ldist, and 1 where ``blocked`` (no light
    reaches there, whatever it passed through).  The pool may be of any
    size (kernels 2.4 and 2.8).  On CUDA tensors the CUDA kernel runs (and
    ``occluded_transparent.launches`` counts it), so the pool's rows must
    be 16-byte aligned; on CPU tensors the plain twin
    ``occluded_transparent_ref`` does."""
    if not _device("occluded_transparent", oT.device):
        return occluded_transparent_ref(res, oT, dT, ldist, skip, d,
                                        order=order)
    w = _occlusion_inputs(res, oT, dT, ldist, skip, d, order, filtered=True)
    _err, out = _occlusion_kernel(
        "ntr_occluded_t", w, oT.device,
        _counted("occluded_transparent", occluded_transparent))
    return out


occluded_transparent.launches = 0


STREAM_INFO = ("registers", "local_bytes", "blocks_per_sm", "ring_slots",
               "shared_bytes")


# the C launch queries of the chunk walks, by wrapper
_INFO_ENTRIES = {"nearest_hit": "ntr_nearest_hit_info",
                 "occluded": "ntr_occluded_info",
                 "nearest_hit_transparent": "ntr_nearest_t_info",
                 "nearest_hit_transparent_hbm": "ntr_nearest_t_hbm_info",
                 "occluded_transparent": "ntr_occluded_t_info"}


def stream_info(name, d, shared=False):
    """The chunk walk ``name`` (one of the five wrappers of kernels
    2.1-2.8, all on the streaming loop) at dimension ``d`` as it launches
    on the current card, for the nearest-hit walks in their ``shared``
    (primary rays) variant or not: registers and local (spill) bytes a
    thread, blocks per SM, ring slots and shared bytes a block
    (``STREAM_INFO``)."""
    from . import _build
    lib = _build.load()
    info = torch.zeros((len(STREAM_INFO),), dtype=torch.int32)
    fn = getattr(lib, _INFO_ENTRIES[name])
    err = fn(d, int(shared), info.data_ptr()) if "nearest" in name \
        else fn(d, info.data_ptr())
    if err:
        raise RuntimeError(f"kernel query failed: {_build.error_string(err)} "
                           f"({err})")
    return dict(zip(STREAM_INFO, info.tolist()))
