"""The exactness arguments of the redesigned grid walks (kernel 2.9,
``grid_nearest_kernel<D, SHARED, RPT>`` in csrc/grid_walk.cu, and 2.10
below), held here to the plain twins ``grid_kernels.nearest_hit_ref`` and
``occluded_ref`` on the CPU in float32 numpy; the kernels themselves are
held to the twins on the card (tests/test_torch_gpu.py).

* The plane records: ``plane_records`` lays the plane rows out triangle by
  triangle, each plane padded to a float4, and the kernel reads plane p of
  triangle t where the twin reads ``gt[p*d:(p+1)*d, t]``.
* The kernel's rule: RPT rays a thread (a warp holds 32 * RPT consecutive
  rays of the block), dots that start at their first product, the sign
  pre-test before the division, the cut t < best before the edges, a warp
  skipping the rest of a triangle once none of its rays can still hit it,
  and the sequential strict < update give the twin's (t, id, tiles) bit
  for bit -- on the 9- and 10-orthoplex and a 16-D pool, primary rays with
  the shared rows and rays of their own origins.
* A sum started at its first product differs from one started at +0 only
  in the sign of a zero.
* The redesigned occlusion grid walk (kernel 2.10, ``grid_occluded_kernel<D,
  RPT>``) runs the same pair test with ldist as the cut and ORs
  ``blocked``; a ray that is blocked, or whose ldist is <= 0 or NaN, tests
  nothing more, and a warp of such rays skips the rest of a tile.  Its rule
  gives the twin ``grid_kernels.occluded_ref``'s ``blocked`` and tiles on
  the 9- and 10-orthoplex's shadow wavefronts (point, global and camera
  light) and a 16-D pool's, with one and two rays a thread.
"""

import numpy as np
import pytest
import torch

from _torch_helpers import _smoke, api, orthoplex_scene
from ntracer_tpu_torch.engine import grid_kernels as gk
from ntracer_tpu_torch.engine import resident_kernels as prk
from ntracer_tpu_torch.engine import wavefront as pwf

F32 = np.float32
RB = 512
N = 2 * RB              # two walk blocks: aimed primary rays, bounce rays


def _random16():
    a = api()
    return _smoke().random_pool(a.NTracer(16), a.Material((0.8, 0.5, 0.9)),
                                200)[0]


SCENES = {
    "orthoplex9": lambda: orthoplex_scene(9),
    "orthoplex10": lambda: orthoplex_scene(10),
    "random16": _random16,
}


def _targets(rng, a, n):
    """``n`` seeded points inside seeded real simplices of the flat pool
    arrays ``a``, barycentric weights at least 1 / (2d)."""
    d = a["tri_fn"].shape[1]
    real = np.nonzero(np.linalg.norm(a["tri_fn"], axis=1) > 0)[0]
    tri = rng.choice(real, n)
    w = rng.uniform(1, 2, (n, d))
    b = (w / w.sum(axis=1, keepdims=True))[:, :d - 1]
    m = np.concatenate([a["tri_fn"][tri][:, None], a["tri_en"][tri]],
                       axis=1).astype(np.float64)
    en_p1 = np.einsum("tid,td->ti", a["tri_en"][tri], a["tri_p1"][tri])
    rhs = np.concatenate([-a["tri_dc"][tri][:, None], en_p1 - b], axis=1)
    return np.linalg.solve(m, rhs[:, :, None])[:, :, 0]


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(F32)


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    """The scene's pool, and two blocks of rays: from the camera, three in
    four aimed at seeded points of the simplices, the rest in seeded
    directions (the shared-origin walk); and rays of their own origins 0.5
    to 2 units before seeded points, in seeded directions, every other one
    skipping the pool id it hits first."""
    scene = SCENES[request.param]()
    cfg, arrs, flat = pwf.get_device_scene(scene, "cpu")
    d = cfg.d
    kern = pwf._kern_dict(arrs)
    rng = np.random.RandomState(5)
    cam = np.asarray(scene._cam._origin, F32)
    dirs = _unit(_targets(rng, flat.arrays, RB) - cam)
    free = rng.rand(RB) < 0.25
    dirs[free] = _unit(rng.normal(size=(int(free.sum()), d)))
    bd = _unit(rng.normal(size=(RB, d)))
    bo = (_targets(rng, flat.arrays, RB)
          - rng.uniform(0.5, 2.0, (RB, 1)) * bd).astype(F32)
    oT = torch.from_numpy(np.concatenate(
        [np.broadcast_to(cam, (RB, d)), bo]).T.copy())
    dT = torch.from_numpy(np.concatenate([dirs, bd]).T.copy())
    skip = torch.full((N,), -1, dtype=torch.int32)
    _t, first, _v = gk.nearest_hit_ref(kern, oT, dT, skip, d)
    skip[RB::2] = first[RB::2]
    sh = gk.shared_rows(kern["gt"], kern["ci"], torch.from_numpy(cam), d)
    return dict(name=request.param, d=d, kern=kern, oT=oT, dT=dT,
                skip=skip, sh=sh)


def kernel_rule(w, rpt, rec):
    """Kernel 2.9's walk of every block of the grid inputs ``w``, ray by
    ray in float32 numpy, reading the plane records ``rec`` (T, d, pw):
    (t, id, tiles, warp stages skipped)."""
    d, shared = w["d"], w["shared"]
    o, dv = w["oT"].numpy(), w["dT"].numpy()
    ci = w["ci"].numpy()
    sk, init = w["skip"].numpy(), w["init_t"].numpy()
    k_any = w["k_any"].reshape(-1).numpy()
    nb, nj = o.shape[1] // RB, len(k_any)
    entries = prk._entry_all(
        d, w["oT"].reshape(d, nb, RB, 1), w["dT"].reshape(d, nb, RB, 1),
        w["k_lo"][:, 0, :].T, w["k_hi"][:, 0, :].T, nj).numpy()
    # the warp of each ray of a block: thread r // rpt, 32 threads a warp
    warp = np.arange(RB) // rpt // 32
    n_warps = warp[-1] + 1
    out_t, out_id = init.copy(), np.full(o.shape[1], -1, np.int32)
    tiles = np.zeros(nb, np.int32)
    skipped = 0
    one = F32(prk.ONE_FUZZ)
    for b in range(nb):
        rs = slice(b * RB, (b + 1) * RB)
        best, bid = init[rs].copy(), np.full(RB, -1, np.int32)
        for j in range(nj):
            if not (entries[b, :, j] < best).any() or k_any[j] == 0:
                continue
            tiles[b] += 1
            for tri in range(j * RB, (j + 1) * RB):
                g = rec[tri]

                def dots(p, rays):
                    od = dd = None
                    for k in range(d):
                        if not shared:
                            x = o[k, rs][rays] * g[p, k]
                            od = x if k == 0 else od + x
                        y = dv[k, rs][rays] * g[p, k]
                        dd = y if k == 0 else dd + y
                    return od, dd

                alive = np.arange(RB)
                od, dd = dots(0, alive)
                num = np.full(RB, ci[0, tri], F32) if shared \
                    else ci[0, tri] - od
                go = sk[rs] != tri
                go &= ((num > 0) & (dd > 0)) | ((num < 0) & (dd < 0))

                def keep(go, alive):
                    """The warps with a ray left; the rest skip."""
                    nonlocal skipped
                    live = np.isin(warp[alive], np.unique(warp[alive][go]))
                    skipped += len(np.unique(warp[alive])) - len(
                        np.unique(warp[alive][live]))
                    return live

                live = keep(go, alive)
                alive, go, num, dd = (alive[live], go[live], num[live],
                                      dd[live])
                t = num / np.where(go, dd, F32(1))
                go &= (t > 0) & (t < best[alive])
                live = keep(go, alive)
                alive, go, t = alive[live], go[live], t[live]
                tot = None
                for i in range(1, d):
                    if not len(alive):
                        break
                    oi, di = dots(i, alive)
                    a = ci[i, tri] - t * di if shared \
                        else (ci[i, tri] - oi) - t * di
                    go &= (a >= -prk.ROUNDING_FUZZ) & (a <= one)
                    tot = a if i == 1 else tot + a
                    live = keep(go, alive)
                    alive, go, t, tot = (alive[live], go[live], t[live],
                                         tot[live])
                if len(alive):
                    win = go & (tot <= one)
                    best[alive[win]] = t[win]
                    bid[alive[win]] = tri
        out_t[rs], out_id[rs] = best, bid
        assert n_warps * 32 * rpt == RB
    return out_t, out_id, tiles, skipped


def occlusion_rule(w, rpt, rec):
    """Kernel 2.10's walk of every block of the grid inputs ``w`` (with
    ``w["ldist"]``), ray by ray in float32 numpy, reading the plane records
    ``rec``: (blocked, tiles, counts) with counts of the warp stages the
    pair test skipped (``stage``), of the triangles a warp of decided rays
    skipped (``decided``) and of the warps whose last live ray was blocked
    inside a sub-tile (``mid``)."""
    d = w["d"]
    o, dv = w["oT"].numpy(), w["dT"].numpy()
    ci, sk, ld = w["ci"].numpy(), w["skip"].numpy(), w["ldist"].numpy()
    k_any = w["k_any"].reshape(-1).numpy()
    nb, nj = o.shape[1] // RB, len(k_any)
    entries = prk._entry_all(
        d, w["oT"].reshape(d, nb, RB, 1), w["dT"].reshape(d, nb, RB, 1),
        w["k_lo"][:, 0, :].T, w["k_hi"][:, 0, :].T, nj).numpy()
    nw = RB // rpt // 32
    warp = np.arange(RB) // rpt // 32
    blocked = np.zeros(o.shape[1], bool)
    tiles = np.zeros(nb, np.int32)
    counts = dict(stage=0, decided=0, mid=0)
    one = F32(prk.ONE_FUZZ)

    def keep(go, alive):
        """The rays of the warps with a ray left; the other warps skip."""
        wa = warp[alive]
        has = np.bincount(wa[go], minlength=nw) > 0
        counts["stage"] += int(((np.bincount(wa, minlength=nw) > 0)
                                & ~has).sum())
        return has[wa]

    for b in range(nb):
        rs = slice(b * RB, (b + 1) * RB)
        ob, db, skb, lb = o[:, rs], dv[:, rs], sk[rs], ld[rs]
        live = lb > 0                   # False for ldist <= 0 and NaN
        for j in range(nj):
            # the vote: only live rays take part
            if not (live & (entries[b, :, j] < lb)).any() or k_any[j] == 0:
                continue
            tiles[b] += 1
            for s0 in range(j * RB, (j + 1) * RB, 32):
                start = np.bincount(warp[live], minlength=nw) > 0
                for tri in range(s0, s0 + 32):
                    wl = np.bincount(warp[live], minlength=nw) > 0
                    counts["decided"] += int(nw - wl.sum())
                    alive = np.nonzero(wl[warp])[0]
                    if not len(alive):
                        continue
                    g = rec[tri]

                    def dots(p, rays):
                        od = dd = None
                        for k in range(d):
                            x = ob[k][rays] * g[p, k]
                            y = db[k][rays] * g[p, k]
                            od = x if k == 0 else od + x
                            dd = y if k == 0 else dd + y
                        return od, dd

                    od, dd = dots(0, alive)
                    num = ci[0, tri] - od
                    go = live[alive] & (skb[alive] != tri)
                    go &= ((num > 0) & (dd > 0)) | ((num < 0) & (dd < 0))
                    k = keep(go, alive)
                    alive, go, num, dd = alive[k], go[k], num[k], dd[k]
                    t = num / np.where(go, dd, F32(1))
                    go &= (t > 0) & (t < lb[alive])
                    k = keep(go, alive)
                    alive, go, t = alive[k], go[k], t[k]
                    tot = None
                    for i in range(1, d):
                        if not len(alive):
                            break
                        oi, di = dots(i, alive)
                        a = (ci[i, tri] - oi) - t * di
                        go &= (a >= -prk.ROUNDING_FUZZ) & (a <= one)
                        tot = a if i == 1 else tot + a
                        k = keep(go, alive)
                        alive, go, t, tot = (alive[k], go[k], t[k], tot[k])
                    if len(alive):
                        win = alive[go & (tot <= one)]
                        blocked[b * RB + win] = True
                        live[win] = False
                end = np.bincount(warp[live], minlength=nw) > 0
                counts["mid"] += int((start & ~end).sum())
    return blocked, tiles, counts


SHADOWS = [("orthoplex9", "point"), ("orthoplex9", "global"),
           ("orthoplex9", "camera"), ("orthoplex10", "point"),
           ("orthoplex10", "global"), ("orthoplex10", "camera"),
           ("random16", "global")]


@pytest.fixture(scope="module")
def shadow_scenes():
    """Each scene's pool and the primary hits of two blocks of rays from
    its camera, three in four aimed at seeded points of the simplices."""
    out = {}
    for name in sorted({s for s, _l in SHADOWS}):
        scene = SCENES[name]()
        cfg, arrs, flat = pwf.get_device_scene(scene, "cpu")
        d = cfg.d
        kern = pwf._kern_dict(arrs)
        rng = np.random.RandomState(7)
        cam = np.asarray(scene._cam._origin, F32)
        dirs = _unit(_targets(rng, flat.arrays, N) - cam)
        free = rng.rand(N) < 0.25
        dirs[free] = _unit(rng.normal(size=(int(free.sum()), d)))
        oT = torch.from_numpy(np.broadcast_to(cam, (N, d)).T.copy())
        dT = torch.from_numpy(dirs.T.copy())
        skip = torch.full((N,), -1, dtype=torch.int32)
        t, pid, _v = gk.nearest_hit_ref(kern, oT, dT, skip, d)
        hit = dict(hit=pid >= 0, pid=pid, pointT=oT + t[None, :] * dT)
        out[name] = (d, kern, arrs, torch.from_numpy(cam), hit)
    return out


@pytest.mark.parametrize("scene,light", SHADOWS)
def test_occlusion_rule_gives_the_twins_outputs(shadow_scenes, scene, light):
    """One and two rays a thread, the live gate (not blocked, ldist > 0),
    the sign pre-test, the warp-uniform skips and the skip of decided warps
    give the twin's ``blocked`` and tiles bit for bit, with some ldist set
    to 0, -1, NaN and inf."""
    d, kern, arrs, cam, hit = shadow_scenes[scene]
    smoke = _smoke()
    pos = dict(point=arrs["pl_pos"][0], camera=cam).get(light)
    point, dirs, ldist = smoke.grid_shadow_rays(
        hit, light_pos=pos,
        light_dir=arrs["gl_dir"][0] if light == "global" else None)
    act = torch.nonzero(ldist > 0).flatten()
    assert act.numel() > 200
    for i, v in enumerate((0.0, -1.0, float("nan"), float("inf"))):
        ldist[act[i::13]] = v
    args = (kern, point, dirs, ldist, hit["pid"], d)
    blocked, tiles = gk.occluded_ref(*args)
    w = gk._grid_inputs(kern, point, dirs, hit["pid"], d, ldist=ldist)
    rec = gk.plane_records(w["gt"], d).numpy()
    for rpt in (1, 2):
        kb, ktl, counts = occlusion_rule(w, rpt, rec)
        print(f"{scene} {light} rpt={rpt}: {int(kb.sum())} blocked, "
              f"tiles {ktl.tolist()}, {counts}")
        assert np.array_equal(kb, blocked.numpy())
        assert np.array_equal(ktl, tiles.numpy())
        assert counts["stage"] > 0
        assert not kb[~(ldist.numpy() > 0)].any()
        if scene != "random16":         # rays that cross the body
            assert kb.any()
        if scene != "random16" and light != "point":
            # whole warps end blocked, some inside a sub-tile
            assert counts["decided"] > 0 and counts["mid"] > 0


def test_plane_records_are_the_plane_rows():
    """Plane p of triangle t in the records is the twin's plane row, each
    plane padded with zeros to a float4."""
    rng = np.random.RandomState(1)
    for d in (3, 9, 10, 16):
        gt = rng.normal(size=(d * d, 1024)).astype(F32)
        got = gk.plane_records(torch.from_numpy(gt), d)
        pw = -(-d // 4) * 4
        assert got.shape == (1024, d, pw) and got.dtype == torch.float32
        assert got.is_contiguous() and pw % 4 == 0
        rec = got.numpy()
        for p in range(d):
            assert np.array_equal(rec[:, p, :d], gt[p * d:(p + 1) * d].T)
        assert not rec[:, :, d:].any()


def test_device_scene_holds_the_plane_records():
    """At d > 8 the device scene carries the records beside the twin's
    rows, and the grid walks' dict hands them to the kernel."""
    cfg, arrs, _flat = pwf.get_device_scene(orthoplex_scene(9), "cpu")
    kern = pwf._kern_dict(arrs)
    assert torch.equal(kern["grec"], gk.plane_records(kern["gt"], cfg.d))


@pytest.mark.parametrize("shared", [True, False])
def test_kernel_rule_gives_the_twins_outputs(case, shared):
    """RPT rays a thread (2 shared, 1 unshared, as the kernel launches, and
    4), the sign pre-test, the warp-uniform skips and the strict < scan
    give the twin's t, id and tiles bit for bit."""
    d = case["d"]
    rays = slice(0, RB) if shared else slice(0, N)
    args = (case["kern"], case["oT"][:, rays].contiguous(),
            case["dT"][:, rays].contiguous(), case["skip"][rays], d)
    kw = dict(sh=case["sh"]) if shared else {}
    t, ids, tiles = gk.nearest_hit_ref(*args, **kw)
    assert int((ids >= 0).sum()) > 100
    w = gk._grid_inputs(*args, **kw)
    rec = gk.plane_records(w["gt"], d).numpy()
    for rpt in ((2, 4) if shared else (1, 4)):
        kt, kid, ktl, skipped = kernel_rule(w, rpt, rec)
        assert np.array_equal(kt.view(np.int32), t.numpy().view(np.int32))
        assert np.array_equal(kid, ids.numpy())
        assert np.array_equal(ktl, tiles.numpy())
        assert skipped > 0


def test_sums_from_the_first_product_differ_only_in_a_zeros_sign():
    rng = np.random.RandomState(3)
    x = rng.choice(np.array([0.0, -0.0, 1.5, -1.5, 2.0 ** -140, 3.0], F32),
                   (20000, 6))
    y = rng.choice(np.array([0.0, -0.0, 1.0, -2.0, 0.25], F32), (20000, 6))
    zero_start = np.zeros(20000, F32)
    first = x[:, 0] * y[:, 0]
    for k in range(6):
        zero_start = zero_start + x[:, k] * y[:, k]
        if k:
            first = first + x[:, k] * y[:, k]
    same = zero_start.view(np.int32) == first.view(np.int32)
    assert np.array_equal(zero_start, first)
    assert (~same).any() and (zero_start[~same] == 0).all()
