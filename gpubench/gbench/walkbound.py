# Frozen copy of chip_smoke.py's walk_bound, pair_ops, staged_pairs, walk_stages and next_up with PEAK_FP32, PEAK_BYTES and DIV_OPS, and of what they replay from ntracer_tpu_torch/engine (resident_kernels.py: the constants, centroid_bins, prepare_resident_cells, _sum_rows, _sqrt, chunk_order, _scene_exit_T, shared_rows_res, _order_boxes, _entry_all, _entry_minima, _find_cands, _twin_step; wavefront.py: make_rays, _fov_params, _frame_groups, _ray_coords) as of commit 5a3cfa5.
"""The walk's roofline share (``walk_roofline.*``): the least time the card
could take for the primary walk of the first traced frame, over that
frame's walk kernel time (``nearest_stream_kernel``, kernels 2.1 and 2.5),
in percent.

The least time is the larger of bytes over the card's memory rate and
float32 instructions over its float32 rate (``walk_bound``).  The
instructions are the pair tests that the TPU visit rule needs on this
frame's rays (``walk_stages``: a 512-ray block visits, nearest first, the
chunks whose entry lies below its farthest ray's nearest hit, four
candidates at a time), each stage of a pair test charged only to the pairs
that reach it.  The count is made on what the benchmark made: the scene's
simplices, chunked here by the frozen ``centroid_bins`` (128 slots a chunk,
boxes the simplices' own), and the frame's camera rays, made here as the
port makes them.  It reads nothing of the program but the kernel's time in
the trace.  The port culls a chunk by the union of the k-d cells that hold
its simplices (flatten.py), which are wider than the simplices' boxes, and
its walk visits more chunks than this replay does (measured against the
port's ``frame_stats`` in test_gpubench_roofline.py; PERF.md gives both
counts on the cells' frames): the share is of the work that tight boxes
need, and a walk that culls tighter can raise it.

Peaks: the kernels are built with --fmad=false, so a lane starts one
float32 add or multiply a clock: 132 SMs x 128 lanes x 1,980 MHz (the
H100 SXM's maximum SM clock), half the data sheet's 67 TFLOP/s, which
counts an FMA as two operations; memory 3.35 TB/s.  Both at the card's
700 W limit.
"""

from __future__ import annotations

import numpy as np
import torch

KERNEL = "nearest_stream_kernel"

SMS, LANES, MAX_SM_CLOCK = 132, 128, 1.98e9
PEAK_FP32 = SMS * LANES * MAX_SM_CLOCK      # float32 instructions/s
PEAK_BYTES = 3.35e12                        # bytes/s
DIV_OPS = 10

RAY_BLOCK = 512
CK = 128
C_PAD = 8
ROUNDING_FUZZ = np.float32(np.finfo(np.float32).eps * 10)
INF = np.float32(np.inf)
BIG = np.float32(3e37)
ONE_FUZZ = float(np.float32(1) + ROUNDING_FUZZ)
EXIT_SCALE = float(np.float32(1) + np.float32(16) * ROUNDING_FUZZ)
P_CAND = 4
# elements of one (blocks, 512, width) slab of the replay (the port's
# twins take 1 << 29 on the card; a quarter keeps the replay's temporaries
# within a few GB)
TWIN_SLAB = {"cuda": 1 << 27, "cpu": 1 << 20}
SENT = 1 << 30
TILE = 32768
MAX_GROUP_TILES = 64
TILE_W = 32
TILE_H = RAY_BLOCK // TILE_W


# --- the chunk layout ------------------------------------------------------

def simplex_rows(tris):
    """p1, face normal, edge normals and plane offset of (N, d, d) float32
    simplices, worked out in float64: fn is the edges' null vector scaled
    to the generalized cross's length, en_i . edge_j = -delta_ij and
    en_i . fn = 0 (``Triangle.from_points``' rows)."""
    p = np.asarray(tris, np.float64)
    p1 = p[:, 0]
    v = p[:, 1:] - p1[:, None]
    m = np.concatenate([v, np.zeros_like(v[:, :1])], axis=1)
    fn = np.empty_like(p1)
    d = p.shape[1]
    for k in range(d):
        minor = np.delete(v, k, axis=2)
        fn[:, k] = (-1) ** (k + d - 1) * np.linalg.det(minor)
    m[:, -1] = fn
    inv = np.linalg.inv(m)                      # m @ inv = I
    en = -np.transpose(inv, (0, 2, 1))[:, :d - 1]
    dc = -(fn * p1).sum(1)
    f32 = np.float32
    return p1.astype(f32), fn.astype(f32), en.astype(f32), dc.astype(f32)


def _pad8(n):
    return -(-n // 8) * 8


def centroid_bins(tri_lo, tri_hi, fn_norm, ck):
    ids_all = np.nonzero(fn_norm > 0)[0]
    if len(ids_all) == 0:
        return []
    cent = (tri_lo + tri_hi) * 0.5
    out = []

    def rec(ids):
        if len(ids) <= ck:
            out.append((tri_lo[ids].min(axis=0), tri_hi[ids].max(axis=0),
                        list(ids)))
            return
        c = cent[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        h = len(ids) // 2
        rec(ids[order[:h]])
        rec(ids[order[h:]])

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


def prepare_resident_cells(treelets, tri_p1, tri_fn, tri_en, tri_dc,
                           tri_lo, tri_hi, d, ck=CK):
    nc = len(treelets)
    gt = np.zeros((nc, _pad8(d * d), ck), np.float32)
    ci = np.zeros((nc, C_PAD, ck), np.float32)
    ids = np.full((nc, C_PAD, ck), -2, np.int32)
    klo = np.full((max(nc, 1), d), BIG, np.float32)
    khi = np.full((max(nc, 1), d), -BIG, np.float32)
    planes = np.concatenate([tri_fn[:, None, :], tri_en], axis=1)
    eo = np.einsum("tid,td->ti", tri_en, tri_p1, dtype=np.float32)
    for k, (cl, ch, pids) in enumerate(treelets):
        pids = np.asarray(pids, np.int64)
        n = len(pids)
        gt[k, :d * d, :n] = planes[pids].reshape(n, d * d).T
        ci[k, 0, :n] = -tri_dc[pids]
        ci[k, 1:d, :n] = eo[pids].T
        ids[k, 0, :n] = pids
        klo[k] = np.maximum(tri_lo[pids].min(axis=0), cl)
        khi[k] = np.minimum(tri_hi[pids].max(axis=0), ch)
    real = np.linalg.norm(tri_fn, axis=1) > 0
    return dict(gt=gt, ci=ci, ids=ids, klo=klo, khi=khi,
                b_lo=tri_lo[real].min(axis=0), b_hi=tri_hi[real].max(axis=0),
                n_eff=nc, base_order=np.arange(max(nc, 1), dtype=np.int32))


# --- the frame's rays ------------------------------------------------------

def _sum_rows(v):
    acc = v[0]
    for i in range(1, v.shape[0]):
        acc = acc + v[i]
    return acc


def _sqrt(x):
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


def _fov_params(w, h, fov):
    half_w = np.float32(w) / np.float32(2)
    half_h = np.float32(h) / np.float32(2)
    fov_i = np.float32(np.tan(np.float32(fov) / np.float32(2)) / half_w)
    return float(fov_i), float(half_w), float(half_h)


def _frame_groups(n_tiles):
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


def _ray_coords(start, w, count, device):
    j = torch.arange(count, dtype=torch.int64, device=device)
    if w % TILE_W == 0 and count % w == 0 and (count // w) % TILE_H == 0:
        tpr = w // TILE_W
        tile = j // (TILE_W * TILE_H)
        within = j % (TILE_W * TILE_H)
        x = (tile % tpr) * TILE_W + within % TILE_W
        y = (tile // tpr) * TILE_H + within // TILE_W
        return x.float(), (start // w + y).float()
    idx = start + j
    return (idx % w).float(), (idx // w).float()


def frame_rays(origin, axes, fov, w, h, device):
    """(oT, dT) (d, R) of a frame's rays in the walk's block order."""
    fov_i, half_w, half_h = _fov_params(w, h, fov)
    xs, ys = zip(*[_ray_coords(s, w, c, device)
                   for s, c in _frame_groups(-(-(w * h) // TILE))])
    xs, ys = torch.cat(xs), torch.cat(ys)
    o = torch.as_tensor(np.asarray(origin, np.float32), device=device)
    t = torch.as_tensor(np.asarray(axes, np.float32), device=device)
    a = fov_i * (xs - half_w)
    b = fov_i * (ys - half_h)
    dT = (t[2][:, None] + t[0][:, None] * a[None, :]) - t[1][:, None] * b[None, :]
    dT = dT / _sqrt(_sum_rows(dT * dT))[None]
    return o[:, None].expand_as(dT).contiguous(), dT


# --- the visit rule --------------------------------------------------------

def chunk_order(klo, khi, origin):
    span_ok = klo <= khi
    cl = torch.minimum(klo, khi)
    ch = torch.maximum(klo, khi)
    p = torch.minimum(torch.maximum(origin[None, :], cl), ch)
    dv = torch.where(span_ok, p - origin[None, :], 0.0)
    dist = _sqrt(_sum_rows((dv * dv).T))
    dist = torch.where(torch.all(span_ok, dim=1), dist, float(BIG))
    _dmin, order = torch.sort(dist, stable=True)
    return order.to(torch.int32)


def _scene_exit_T(oT, dT, b_lo, b_hi):
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
    nc, _pr, ck = gt.shape
    sh = torch.zeros((nc, C_PAD, ck), dtype=torch.float32, device=gt.device)
    for p in range(d):
        acc = torch.zeros((nc, ck), dtype=torch.float32, device=gt.device)
        for c in range(d):
            acc = acc + origin[c] * gt[:, p * d + c, :]
        sh[:, p, :] = ci[:, p, :] - acc
    return sh


def _order_boxes(res, order, d):
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


def _entry_all(d, o, dv, klo_t, khi_t, n):
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


def _twin_step(width, device_type):
    kind = "cuda" if device_type == "cuda" else "cpu"
    return max(1, TWIN_SLAB[kind] // (RAY_BLOCK * max(width, 1)))


def _entry_minima(w, o, dv):
    n, nb = w["n_eff"], o.shape[1]
    step = _twin_step(n, o.device.type)
    return torch.cat([
        torch.amin(_entry_all(w["d"], o[:, b:b + step], dv[:, b:b + step],
                              w["klo_t"], w["khi_t"], n), dim=1)
        for b in range(0, nb, step)])


def _find_cands(emin, bound, k0, n, p=P_CAND):
    posi = torch.arange(n, dtype=torch.int64, device=emin.device)
    cand = (emin < bound[:, None]) & (posi[None, :] >= k0[:, None])
    cp = torch.where(cand, posi[None, :], SENT)
    if n < p:
        cp = torch.cat([cp, torch.full((cp.shape[0], p - n), SENT,
                                       dtype=cp.dtype, device=cp.device)], 1)
    return torch.topk(cp, p, dim=1, largest=False, sorted=True).values


# --- the count and the bound -----------------------------------------------

def pair_ops(d, shared):
    """Float32 instructions each stage of a pair test costs: [the plane-0
    dots and numerator, the division, edge 1, ..., edge d-1]."""
    dot = 2 * d - 1
    base = dot if shared else 2 * dot + 1
    edge = dot + 2 if shared else 2 * dot + 3
    return [base, DIV_OPS] + [edge + (i > 1) for i in range(1, d)]


def walk_bound(d, shared, need, read, stages, chunks, pool_bytes,
               mask_bytes, out_bytes):
    """The least time (ms) for one walk on this data and which bound it is:
    the larger of bytes over the memory rate and operations over the
    float32 rate."""
    rays = need.numel()
    read_blocks = int(read.reshape(-1, 512).any(dim=1).sum())
    in_bytes = read_blocks * 512 * (2 * d * 4 + 4) + rays * mask_bytes \
        + pool_bytes
    bytes_ms = 1e3 * (in_bytes + out_bytes) / PEAK_BYTES
    costs = pair_ops(d, shared)
    ops = sum(int(n) * c for n, c in zip(stages, costs, strict=True))
    ops += int(need.sum()) * chunks * 4 * d
    ops_ms = 1e3 * ops / PEAK_FP32
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms \
        else (ops_ms, "operations")


def staged_pairs(d, shared, g, ci, idrow, o, dv, skip, charged, cut):
    """The pair test of ``n`` ray blocks against their own chunks, and the
    counts (d + 1,) of the ``charged`` rays' pairs that reach each stage of
    ``pair_ops``."""
    zeros = torch.zeros((1,), dtype=torch.float32, device=g.device)

    def dots(p):
        acc_o = None if shared else zeros
        acc_d = zeros
        for c in range(d):
            row = g[:, None, p * d + c, :]
            if not shared:
                acc_o = acc_o + o[c] * row
            acc_d = acc_d + dv[c] * row
        return acc_o, acc_d

    o0, dn = dots(0)
    num = ci[:, None, 0, :] if shared else ci[:, None, 0, :] - o0
    t = num / dn
    own = idrow[:, None, :] != skip
    valid = (dn != 0) & (t > 0) & own
    base = charged[:, :, None] & own
    pre = base & (((num > 0) & (dn > 0)) | ((num < 0) & (dn < 0)))
    reach = pre & (t > 0) & (t < cut)
    counts = [base.sum(), pre.sum(), reach.sum()]
    tot = zeros
    for i in range(1, d):
        oi, di = dots(i)
        a = ci[:, None, i, :] - t * di if shared \
            else ci[:, None, i, :] - oi - t * di
        ok = (a >= -ROUNDING_FUZZ) & (a <= ONE_FUZZ)
        valid &= ok
        tot = tot + a
        if i < d - 1:
            reach &= ok
            counts.append(reach.sum())
    valid &= tot <= ONE_FUZZ
    return t, valid, torch.stack(counts)


def walk_stages(w, charged, cut):
    """Replay a nearest-hit walk's visits with the visit rule and count the
    pair tests of the ``charged`` rays that reach each stage.  Returns
    (stages (d + 1,) list, each ray's nearest t (R,), the chunks visited
    summed over the 512-ray blocks)."""
    d = w["d"]
    dev = w["oT"].device
    nb_all = w["oT"].shape[1] // RAY_BLOCK
    stages = torch.zeros((d + 1,), dtype=torch.int64, device=dev)
    visits = 0
    step = _twin_step(CK, dev.type)
    inf = float(INF)
    bests = []
    for b0 in range(0, nb_all, step):
        b1 = min(nb_all, b0 + step)
        nb, sl = b1 - b0, slice(b0 * RAY_BLOCK, b1 * RAY_BLOCK)
        o = w["oT"][:, sl].reshape(d, nb, RAY_BLOCK, 1)
        dv = w["dT"][:, sl].reshape(d, nb, RAY_BLOCK, 1)
        skip = w["skip"][sl].reshape(nb, RAY_BLOCK, 1)
        chg = charged[sl].reshape(nb, RAY_BLOCK)
        ct = cut[sl].reshape(nb, RAY_BLOCK, 1)
        best = w["init_t"][sl].reshape(nb, RAY_BLOCK).clone()

        def visit(sel, g, ci, idrow):
            t, valid, cnt = staged_pairs(
                d, w["shared"], g, ci, idrow, o[:, sel], dv[:, sel],
                skip[sel], chg[sel], ct[sel])
            stages.add_(cnt)
            c_t = torch.amin(torch.where(valid, t, inf), dim=2)
            best[sel] = torch.where(c_t < best[sel], c_t, best[sel])

        n = w["n_eff"]
        emin = _entry_minima(w, o, dv)
        order = w["order"].long()
        none = torch.full((nb,), n, dtype=torch.int64, device=dev)
        cur = _find_cands(emin, torch.amax(best, dim=1),
                          torch.zeros_like(none), n)
        cur[w["blive"][b0:b1] == 0] = SENT
        while bool((cur[:, 0] < SENT).any()):
            k0 = torch.where(cur[:, -1] < SENT, cur[:, -1] + 1, none)
            nxt = _find_cands(emin, torch.amax(best, dim=1), k0, n)
            for j in range(P_CAND):
                sel = torch.nonzero(cur[:, j] < SENT).squeeze(1)
                if sel.numel() == 0:
                    continue
                visits += sel.numel()
                idx = order[cur[sel, j]]
                visit(sel, w["gt"][idx], w["ci"][idx], w["ids"][idx, 0])
            cur = nxt
        bests.append(best.reshape(-1))
    return stages.tolist(), torch.cat(bests), visits


def bound_of_frame(tris, origin, axes, fov, width, height, device):
    """(bound ms, "bytes" or "operations", needed rays, chunks visited
    summed over the blocks) of the primary walk of one frame."""
    p1, fn, en, dc = simplex_rows(tris)
    d = p1.shape[1]
    lo = np.asarray(tris, np.float32).min(axis=1)
    hi = np.asarray(tris, np.float32).max(axis=1)
    bins = centroid_bins(lo, hi, np.linalg.norm(fn, axis=1), CK)
    host = prepare_resident_cells(bins, p1, fn, en, dc, lo, hi, d)
    res = {k: torch.as_tensor(v, device=device) for k, v in host.items()
           if k != "n_eff"}
    oT, dT = frame_rays(origin, axes, fov, width, height, device)
    origin_t = oT[:, 0].contiguous()
    order = chunk_order(res["klo"], res["khi"], origin_t)
    init_t = _scene_exit_T(oT, dT, res["b_lo"], res["b_hi"])
    klo_t, khi_t = _order_boxes(res, order, d)
    w = dict(d=d, shared=True, oT=oT, dT=dT,
             skip=torch.full((oT.shape[1],), -1, dtype=torch.int32,
                             device=device),
             init_t=init_t, order=order, n_eff=host["n_eff"],
             blive=(torch.amax(init_t.reshape(-1, RAY_BLOCK), dim=1) > 0)
             .to(torch.int32), klo_t=klo_t, khi_t=khi_t, gt=res["gt"],
             ci=shared_rows_res(res["gt"], res["ci"], origin_t, d),
             ids=res["ids"])
    need = init_t > 0
    # a first pass finds each ray's nearest hit; the count charges a pair
    # only while it can still matter (t at most the nearest)
    _stages, best, visits = walk_stages(w, need,
                                        torch.full_like(init_t, float(INF)))
    cut = torch.nextafter(best, torch.full_like(best, float("inf")))
    stages, _best, _visits = walk_stages(w, need, cut)
    pool = sum(res[k].numel() * 4 for k in ("gt", "ci", "ids", "klo", "khi",
                                            "base_order"))
    nb = oT.shape[1] // RAY_BLOCK
    ms, by = walk_bound(d, True, need, torch.ones_like(need), stages,
                        host["n_eff"], pool, 0, oT.shape[1] * 8 + nb * 4)
    return ms, by, int(need.sum()), visits


def read(run):
    tr = run["traced"]
    if not tr:
        return None
    launches = sorted((s, e) for n, s, e in tr["ops"] if KERNEL in n)
    if len(launches) != tr["frames"]:
        return None
    k = tr["first"]
    n_steps = len(run["origins"])
    step = (run["start"] + k) % n_steps
    device = "cuda" if torch.cuda.is_available() else "cpu"
    f = run["fmt"]
    ms, by, need, visits = bound_of_frame(
        run["tris"], run["origins"][step], run["axes"][step],
        run["config"]["fov"], f["width"], f["height"], device)
    walk_ms = 1e3 * (launches[0][1] - launches[0][0])
    run["notes"].append(f"walk roofline: frame {k}: bound {ms:.4f} ms "
                        f"({by}), {need} rays to test, {visits} chunk "
                        f"visits, walk {walk_ms:.4f} ms")
    return 100.0 * ms / walk_ms
