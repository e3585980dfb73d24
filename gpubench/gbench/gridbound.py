# Frozen copy of chip_smoke.py's grid_walk_stages (the grid branch of walk_stages) and grid_pool_bytes, and of what they replay from ntracer_tpu_torch/engine/grid_kernels.py (TRI_BLOCK, prepare_tri_arrays, shared_rows, _grid_inputs, _grid_blocks' vote) as of commit f8136a5; walk_bound, pair_ops, staged_pairs, the rays and the slab entries are gbench/walkbound.py's.
"""The grid walk's roofline share (``walk_roofline.orth``): the least time
the card could take for the primary walk of the first traced frame, over
that frame's grid walk kernel time (``grid_nearest_kernel``, kernel 2.9),
in percent.

The least time is ``walkbound.walk_bound``: the larger of bytes over the
card's memory rate and float32 instructions over its float32 rate, at the
same peaks.  The instructions are the pair tests that the TPU grid rule
needs on this frame's rays (``walk_tiles``): each 512-ray block visits the
pool's 512-triangle tiles in pool order, and before each tile, with its
rays' nearest hits so far, votes: the tile runs when it holds a simplex and
some ray of the block enters the tile's box before its nearest hit so far.
The first nearest hit is the ray's exit from the pool's box x (1 + 16
fuzz), 0 for a ray that misses it.  Each stage of a pair test is charged
only to the pairs that reach it, and only while the pair can still matter
(t at most the ray's nearest hit); the slab entries of the needed rays
into every tile's box count too.

The count is made on what the benchmark made: the scene's simplices in the
order the configuration's builder gives them, padded with empty slots to
whole tiles, each tile boxed by its own simplices, and the frame's camera
rays, made here as the port makes them.  It reads nothing of the program
but the kernel's time in the trace, and it counts the same work whatever
kernel implements the walk.  The port orders its pool by k-d leaves and
boxes a tile by the k-d cells that hold its simplices, which are at least
as wide as the simplices' own boxes: on the 10-orthoplex every tile's box
is the pool's box either way (test_gpubench_gridbound.py holds the
replay's tiles equal to the port's on its frames).
"""

from __future__ import annotations

import numpy as np
import torch

from . import walkbound as wb

KERNEL = "grid_nearest_kernel"
TRI_BLOCK = 512
RAY_BLOCK = wb.RAY_BLOCK


# --- the pool --------------------------------------------------------------

def grid_pool(tris, device):
    """The pool of (N, d, d) simplices as the grid walks take it, as torch
    tensors on ``device``: plane rows ``gt`` (d*d, T), plane-major with the
    face normal first; offset rows ``ci`` (d, T), row 0 the plane offset
    -dc and row i the edge offset en_i . p1; per tile the box ``k_lo``,
    ``k_hi`` (tiles, d) of its real simplices and ``k_any`` (tiles,), 1
    where it holds one; the pool's box ``b_lo``, ``b_hi`` (d,).  T is N
    rounded up to whole tiles; the empty slots are zeros (a zero face
    normal: never hit)."""
    tris = np.asarray(tris, np.float32)
    p1, fn, en, dc = wb.simplex_rows(tris)
    n, d = p1.shape
    T = max(TRI_BLOCK, -(-n // TRI_BLOCK) * TRI_BLOCK)
    planes = np.concatenate([fn[:, None, :], en], axis=1)      # (n, d, d)
    gt = np.zeros((d * d, T), np.float32)
    gt[:, :n] = planes.transpose(1, 2, 0).reshape(d * d, n)
    ci = np.zeros((d, T), np.float32)
    ci[0, :n] = -dc
    ci[1:, :n] = np.einsum("tid,td->it", en, p1, dtype=np.float32)
    lo, hi = tris.min(axis=1), tris.max(axis=1)
    real = np.linalg.norm(fn, axis=1) > 0
    nk = T // TRI_BLOCK
    k_lo = np.zeros((nk, d), np.float32)
    k_hi = np.zeros((nk, d), np.float32)
    k_any = np.zeros((nk,), np.float32)
    for k in range(nk):
        sl = slice(k * TRI_BLOCK, min(n, (k + 1) * TRI_BLOCK))
        r = real[sl]
        if r.any():
            k_lo[k] = lo[sl][r].min(axis=0)
            k_hi[k] = hi[sl][r].max(axis=0)
            k_any[k] = 1.0
    live = k_any > 0
    b_lo = k_lo[live].min(axis=0) if live.any() else np.zeros(d, np.float32)
    b_hi = k_hi[live].max(axis=0) if live.any() else np.zeros(d, np.float32)
    out = dict(gt=gt, ci=ci, k_lo=k_lo, k_hi=k_hi, k_any=k_any, b_lo=b_lo,
               b_hi=b_hi)
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def pool_bytes(pool):
    """Bytes of the pool's rows and tile boxes (the shared rows of a
    primary walk replace ``ci`` and have its size)."""
    return sum(pool[k].numel() * 4 for k in
               ("gt", "ci", "k_lo", "k_hi", "k_any"))


def shared_rows(gt, ci, origin, d):
    """Rows for rays that share one origin: row 0 the t numerator
    ``ci[0] - o . n_0``, row p the edge bound ``ci[p] - o . n_p``, the
    origin dots accumulated coordinate by coordinate from 0.  -> (d, T)."""
    rows = []
    for p in range(d):
        acc = torch.zeros((gt.shape[1],), dtype=torch.float32,
                          device=gt.device)
        for c in range(d):
            acc = acc + origin[c] * gt[p * d + c]
        rows.append(ci[p] - acc)
    return torch.stack(rows)


# --- the replay ------------------------------------------------------------

def walk_tiles(w, charged, cut):
    """Replay the grid rule over the rays of ``w`` (``oT``, ``dT`` (d, R),
    ``init_t`` (R,), the pool's tensors and ``sh``, its shared rows) and
    count the pair tests of the ``charged`` (R,) rays that reach each stage
    of ``walkbound.pair_ops``, a pair charged while its t is below ``cut``
    (R,).  Returns (stages (d + 1,) list, each ray's nearest t (R,), the
    tiles each 512-ray block ran (R // 512,) int32)."""
    d = w["d"]
    dev = w["oT"].device
    nb_all = w["oT"].shape[1] // RAY_BLOCK
    stages = torch.zeros((d + 1,), dtype=torch.int64, device=dev)
    step = wb._twin_step(TRI_BLOCK, dev.type)
    inf = float(wb.INF)
    live = [j for j, a in enumerate(w["k_any"].tolist()) if a != 0]
    k_lo_t, k_hi_t = w["k_lo"].T, w["k_hi"].T
    ids = torch.arange(TRI_BLOCK, device=dev)
    skip = torch.full((1, RAY_BLOCK, 1), -1, dtype=torch.int64, device=dev)
    bests, tiles = [], []
    for b0 in range(0, nb_all, step):
        b1 = min(nb_all, b0 + step)
        nb, sl = b1 - b0, slice(b0 * RAY_BLOCK, b1 * RAY_BLOCK)
        o = w["oT"][:, sl].reshape(d, nb, RAY_BLOCK, 1)
        dv = w["dT"][:, sl].reshape(d, nb, RAY_BLOCK, 1)
        chg = charged[sl].reshape(nb, RAY_BLOCK)
        ct = cut[sl].reshape(nb, RAY_BLOCK, 1)
        best = w["init_t"][sl].reshape(nb, RAY_BLOCK).clone()
        ran = torch.zeros((nb,), dtype=torch.int32, device=dev)
        entries = wb._entry_all(d, o, dv, k_lo_t, k_hi_t, k_lo_t.shape[1])
        for j in live:
            run = torch.any(entries[:, :, j] < best, dim=1)
            sel = torch.nonzero(run).squeeze(1)
            if sel.numel() == 0:
                continue
            cols = slice(j * TRI_BLOCK, (j + 1) * TRI_BLOCK)
            t, valid, cnt = wb.staged_pairs(
                d, True, w["gt"][None, :, cols], w["sh"][None, :, cols],
                (j * TRI_BLOCK + ids)[None], o[:, sel], dv[:, sel],
                skip.expand(sel.numel(), -1, -1), chg[sel], ct[sel])
            stages.add_(cnt)
            c_t = torch.amin(torch.where(valid, t, inf), dim=2)
            best[sel] = torch.where(c_t < best[sel], c_t, best[sel])
            ran[sel] += 1
        bests.append(best.reshape(-1))
        tiles.append(ran)
    return stages.tolist(), torch.cat(bests), torch.cat(tiles)


def frame_walk(tris, origin, axes, fov, width, height, device):
    """The walk's inputs for one frame: the pool (``grid_pool``), the
    frame's rays in the walk's block order, their pool exit ``init_t`` and
    the shared rows."""
    pool = grid_pool(tris, device)
    d = pool["b_lo"].shape[0]
    oT, dT = wb.frame_rays(origin, axes, fov, width, height, device)
    init_t = wb._scene_exit_T(oT, dT, pool["b_lo"], pool["b_hi"])
    sh = shared_rows(pool["gt"], pool["ci"], oT[:, 0].contiguous(), d)
    return dict(pool, d=d, oT=oT, dT=dT, init_t=init_t, sh=sh)


def bound_of_walk(w):
    """(bound ms, "bytes" or "operations", needed rays, the tiles each
    512-ray block ran) of the primary grid walk of the rays of ``w``
    (``frame_walk``)."""
    need = w["init_t"] > 0
    # a first pass finds each ray's nearest hit; the count charges a pair
    # only while it can still matter (t at most the nearest)
    _stages, best, tiles = walk_tiles(
        w, need, torch.full_like(w["init_t"], float(wb.INF)))
    cut = torch.nextafter(best, torch.full_like(best, float("inf")))
    stages, _best, _tiles = walk_tiles(w, need, cut)
    R = w["oT"].shape[1]
    ms, by = wb.walk_bound(w["d"], True, need, torch.ones_like(need), stages,
                           w["k_any"].numel(), pool_bytes(w), 0,
                           R * 8 + tiles.numel() * 4)
    return ms, by, int(need.sum()), tiles


def bound_of_frame(tris, origin, axes, fov, width, height, device):
    """``bound_of_walk`` of the primary grid walk of one frame."""
    return bound_of_walk(frame_walk(tris, origin, axes, fov, width, height,
                                    device))


def read(run):
    tr = run["traced"]
    if not tr:
        return None
    launches = sorted((s, e) for n, s, e in tr["ops"] if KERNEL in n)
    if len(launches) != tr["frames"]:
        return None
    k = tr["first"]
    step = (run["start"] + k) % len(run["origins"])
    device = "cuda" if torch.cuda.is_available() else "cpu"
    f = run["fmt"]
    ms, by, need, tiles = bound_of_frame(
        run["tris"], run["origins"][step], run["axes"][step],
        run["config"]["fov"], f["width"], f["height"], device)
    walk_ms = 1e3 * (launches[0][1] - launches[0][0])
    run["notes"].append(
        f"grid walk roofline: frame {k}: bound {ms:.4f} ms ({by}), {need} "
        f"rays to test, {int(tiles.sum())} tiles run over {tiles.numel()} "
        f"blocks ({int((tiles > 0).sum())} live), walk {walk_ms:.4f} ms")
    return 100.0 * ms / walk_ms
