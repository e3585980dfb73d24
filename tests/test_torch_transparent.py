"""The port's transparent walks vs the JAX package.

The JAX side runs the Pallas kernels ``nearest_hit_transparent`` and
``occluded_transparent`` in interpret mode (the device scene is built under
NTRACER_FORCE_KERNELS).  Both engines get the same rays, layouts and opacity
row, so differences can only come from the walks.

Contract held here.  The K slots are compared position by position: which
slot a hit lands in follows from the visit set and the replace-the-first-
largest rule, and the stable sort downstream composes exactly tied surfaces
in slot order.  Ids and slots are exact (the port's slots are mapped to pool
ids through ``res_ids``), visits equal, t and tt agree to rtol 1e-6 plus the
rounding bound of the pair test's numerator (XLA on the CPU contracts a*b+c
into FMAs inside the interpreted kernel; the twin rounds every operation).
``blocked`` is exact at any candidate grouping, visits equal at the default
grouping (4), and ``filt`` is exact on unblocked rays (the port's contract
sets it to 1 on blocked ones, where the JAX package leaves a don't-care).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu.engine import resident_kernels as jrk
from ntracer_tpu_torch.engine import wavefront as pwf
from ntracer_tpu_torch.engine import resident_kernels as prk

from _torch_helpers import (JAX, glass_scene, polytope_scene,
                            jax_device_scene)
from test_torch_resident import _t_rounding_bound

W = H = 64
N = W * H             # the whole frame: 8 walk blocks

SCENES = {
    "3d_mixed_600": lambda: glass_scene(600, pkg=JAX),
    "3d_all_glass": lambda: glass_scene(500, seed=3, spread=0.7,
                                        all_glass=True, pkg=JAX),
    "4d_600cell": lambda: polytope_scene(glass=True, pkg=JAX),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    """A scene with transparent materials, its JAX device scene and the
    frame's primary wavefront (tile order) as both engines' inputs."""
    mp = pytest.MonkeyPatch()
    scene = SCENES[request.param]()
    cfg, arrs, _flat = jax_device_scene(scene, mp)
    dev = jwf.get_device_scene(scene)[1]
    mp.undo()
    assert cfg.has_transparency and "res_opa" in arrs
    scene._set_view_size(W, H)
    fov = jwf._fov_params(W, H, scene.fov)
    xs, ys, _ = jwf._ray_coords(0, W, N)
    origin = np.asarray(scene._cam._origin, np.float32)
    o, dirs = jwf.make_rays(jnp.asarray(origin), jnp.asarray(scene._cam._t),
                            *fov, xs, ys)
    pctx = jwf.primary_ctx(dev, cfg, jnp.asarray(origin))
    jres = jwf._res_dict(dev)
    jres["opa"] = dev["res_opa"]
    tens = pwf.tensors_from_arrays(arrs, "cpu")
    return dict(name=request.param, cfg=cfg, arrs=arrs, jres=jres,
                pctx={k: np.asarray(v) for k, v in pctx.items()},
                o=np.asarray(o), dirs=np.asarray(dirs), origin=origin,
                tens=tens, pres=pwf._res_dict(tens))


def _bounce_inputs(case):
    """A bounce-mode wavefront: seeded origins inside the pool's box and
    seeded directions, every other block inactive, half the rays skipping
    the pool id of the first surface along them."""
    rng = np.random.RandomState(11)
    d = case["cfg"].d
    lo, hi = case["arrs"]["res_blo"], case["arrs"]["res_bhi"]
    o = (lo + (hi - lo) * rng.uniform(0.25, 0.75, (N, d))).astype(np.float32)
    dirs = rng.normal(size=(N, d))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)) \
        .astype(np.float32)
    none = jnp.full((N,), -1, jnp.int32)
    jt, gid, jtt, jtid, _ = jrk.nearest_hit_transparent(
        case["jres"], jnp.asarray(o), jnp.asarray(dirs), none, d, 8)
    jt, gid, jtt, jtid = (np.asarray(x) for x in (jt, gid, jtt, jtid))
    first_t = np.where(jtid >= 0, jtt, np.inf)
    k = first_t.argmin(axis=1)
    tfirst = np.take_along_axis(jtid, k[:, None], axis=1)[:, 0]
    nearer = np.take_along_axis(first_t, k[:, None], axis=1)[:, 0] < jt
    first = np.where(nearer & (tfirst >= 0), tfirst, gid)
    skip = np.where((first >= 0) & (np.arange(N) % 2 == 0), first, -1) \
        .astype(np.int32)
    active = np.arange(N) // jrk.RAY_BLOCK % 2 == 0
    return o, dirs, skip, active


@pytest.mark.parametrize("K", [8, 2])
@pytest.mark.parametrize("mode", ["primary", "bounce"])
def test_nearest_hit_transparent_ref_matches_pallas(case, mode, K):
    d = case["cfg"].d
    if mode == "primary":
        o, dirs = case["o"], case["dirs"]
        skip = np.full((N,), -1, np.int32)
        jkw = dict(order=jnp.asarray(case["pctx"]["order"]),
                   dmin=jnp.asarray(case["pctx"]["dmin"]),
                   sh=jnp.asarray(case["pctx"]["sh_res"]))
        pkw = dict(order=_t(case["pctx"]["order"]),
                   sh=_t(case["pctx"]["sh_res"]))
    else:
        o, dirs, skip, active = _bounce_inputs(case)
        jkw = dict(active=jnp.asarray(active))
        pkw = dict(active=_t(active))
    jt, jgid, jtt, jtgid, jvis = jrk.nearest_hit_transparent(
        case["jres"], jnp.asarray(o), jnp.asarray(dirs), jnp.asarray(skip),
        d, K, **jkw)
    jt, jgid, jvis = np.asarray(jt), np.asarray(jgid), np.asarray(jvis)
    jtt, jtgid = np.asarray(jtt).T, np.asarray(jtgid).T          # (K, R)
    pt, pslot, ptt, ptslot, pvis = prk.nearest_hit_transparent_ref(
        case["pres"], _t(o.T), _t(dirs.T), _t(skip), d, K, **pkw)
    pt, pslot, ptt, ptslot = (x.numpy() for x in (pt, pslot, ptt, ptslot))
    assert ptt.shape == (K, N) and ptslot.shape == (K, N)
    assert ptslot.dtype == np.int32 and pslot.dtype == np.int32

    # ids: the port's slots through the pool's id row
    slot_ids = case["arrs"]["res_ids"][:, 0, :].reshape(-1)
    pgid = np.where(pslot >= 0, slot_ids[np.clip(pslot, 0, None)], -1)
    ptgid = np.where(ptslot >= 0, slot_ids[np.clip(ptslot, 0, None)], -1)
    assert np.array_equal(pgid, jgid)
    assert np.array_equal(ptgid, jtgid), \
        f"{int((ptgid != jtgid).sum())} slot entries differ"
    assert np.array_equal(pvis.numpy(), jvis)

    hits = jgid >= 0
    bound = _t_rounding_bound(o, dirs, pslot, case["arrs"], d)
    assert (np.abs(pt - jt) <= 1e-6 * np.abs(jt) + bound)[hits].all()
    assert np.array_equal(pt[~hits], jt[~hits])
    filled = ptslot >= 0
    assert np.array_equal(np.isinf(ptt), ~filled)
    for k in range(K):
        m = filled[k]
        bk = _t_rounding_bound(o, dirs, ptslot[k], case["arrs"], d)
        assert (np.abs(ptt[k] - jtt[k]) <= 1e-6 * np.abs(jtt[k]) + bk)[m].all()
    n_full = int(filled.all(axis=0).sum())
    print(f"{case['name']} {mode} K={K}: {int(hits.sum())} opaque hits, "
          f"{int(filled.sum())} slots filled, {n_full} rays filled all {K}")
    assert filled.sum() > (100 if mode == "primary" else 20)
    if K == 2 and mode == "primary" and case["name"] != "4d_600cell":
        # more transparent surfaces than slots: slots were replaced
        assert n_full > 20
    if mode == "bounce":
        assert (pvis.numpy()[1::2] == 0).all()
        assert not filled[:, ~_block_mask()].any()


def _block_mask():
    return np.arange(N) // prk.RAY_BLOCK % 2 == 0


def test_slots_are_replaced_by_nearer_hits(case):
    """With fewer slots than surfaces the K kept are the K nearest: sorted,
    the K = 2 slots equal the two nearest of the K = 8 slots wherever fewer
    than 8 were found (then K = 8 holds every transparent hit)."""
    d = case["cfg"].d
    args = (case["pres"], _t(case["o"].T), _t(case["dirs"].T),
            torch.full((N,), -1, dtype=torch.int32), d)
    kw = dict(order=_t(case["pctx"]["order"]), sh=_t(case["pctx"]["sh_res"]))
    _, _, tt8, ts8, _ = prk.nearest_hit_transparent(*args, 8, **kw)
    _, _, tt2, ts2, _ = prk.nearest_hit_transparent(*args, 2, **kw)
    complete = (ts8 < 0).any(dim=0)
    s8, _ = torch.sort(tt8, dim=0)
    s2, _ = torch.sort(tt2, dim=0)
    if case["name"] != "4d_600cell":    # a convex body is crossed twice
        assert int((complete & (ts8 >= 0).sum(dim=0).gt(2)).sum()) > 20
    assert torch.equal(s2[:, complete], s8[:2, complete])
    # the twin counts the filled slots that a nearer hit took over
    ref2 = prk.nearest_hit_transparent_ref(*args, 2, **kw)
    assert torch.equal(ref2[2], tt2) and torch.equal(ref2[3], ts2)
    replaced = prk.nearest_hit_transparent_ref.replaced
    assert (replaced == 0) == (case["name"] == "4d_600cell"), replaced


def _shadow_inputs(case):
    """Shadow rays from the first surface along each ray of the primary
    wavefront (opaque or transparent), skipping that surface, every other
    block dead."""
    d = case["cfg"].d
    pt, pslot, ptt, ptslot, _ = prk.nearest_hit_transparent(
        case["pres"], _t(case["o"].T), _t(case["dirs"].T),
        torch.full((N,), -1, dtype=torch.int32), d, 8,
        order=_t(case["pctx"]["order"]), sh=_t(case["pctx"]["sh_res"]))
    all_t = np.concatenate([np.where(pslot.numpy() >= 0, pt.numpy(),
                                     np.inf)[None], ptt.numpy()])
    k = all_t.argmin(axis=0)[None]
    first = np.take_along_axis(all_t, k, axis=0)[0]
    slot = np.take_along_axis(
        np.concatenate([pslot.numpy()[None], ptslot.numpy()]), k, axis=0)[0]
    m = np.isfinite(first)
    skip = np.where(m, case["arrs"]["res_ids"][:, 0, :].reshape(-1)[
        np.clip(slot, 0, None)], -1).astype(np.int32)
    point = np.where(m[:, None], case["o"] + np.where(m, first, 0)[:, None]
                     * case["dirs"], 0).astype(np.float32)
    live = m & _block_mask()
    pos = np.zeros(d, np.float32)
    pos[0], pos[1], pos[2] = -1, 2, -3
    lv = point - pos
    dist = np.sqrt((lv * lv).sum(axis=1)).astype(np.float32)
    lv = (lv / dist[:, None]).astype(np.float32)
    return point, lv, np.where(live, dist, 0).astype(np.float32), skip, live


def test_occluded_transparent_ref_matches_pallas(case):
    d = case["cfg"].d
    point, dirs, ldist, skip, live = _shadow_inputs(case)
    pb, pf, pv = prk.occluded_transparent_ref(
        case["pres"], _t(point.T), _t(dirs.T), _t(ldist), _t(skip), d)
    pb, pf, pv = pb.numpy(), pf.numpy(), pv.numpy()
    assert pb.dtype == np.bool_ and pf.dtype == np.float32
    for cand in (1, 4):
        jb, jf, jv = jrk.occluded_transparent(
            case["jres"], jnp.asarray(point), jnp.asarray(dirs),
            jnp.asarray(ldist), jnp.asarray(skip), d, cand=cand)
        jb, jf, jv = np.asarray(jb), np.asarray(jf), np.asarray(jv)
        assert np.array_equal(pb, jb), f"cand={cand}"
        assert np.array_equal(pf[~pb], jf[~pb]), f"cand={cand}"
        if cand == 4:
            assert np.array_equal(pv, jv)
        else:
            assert (pv >= jv).all()
    # the port's contract: a blocked ray's filt is 1
    assert (pf[pb] == 1).all() and (pf[~live] == 1).all()
    assert not pb[~live].any()
    print(f"{case['name']}: {int(live.sum())} live, {int(pb.sum())} blocked, "
          f"{int(((pf < 1) & ~pb).sum())} filtered")
    assert ((pf < 1) & ~pb).sum() > 20
    if case["name"] != "3d_all_glass":
        assert pb[live].any() and not pb[live].all()
    else:
        assert not pb.any()
    assert (pv[1::2] == 0).all() and pv[0::2].any()


def test_wrappers_take_the_twins_on_cpu(case):
    d = case["cfg"].d
    args = (case["pres"], _t(case["o"].T), _t(case["dirs"].T),
            torch.full((N,), -1, dtype=torch.int32), d)
    before = (prk.nearest_hit_transparent.launches,
              prk.occluded_transparent.launches)
    got = prk.nearest_hit_transparent(*args, 4)
    ref = prk.nearest_hit_transparent_ref(*args, 4)
    point, dirs, ldist, skip, _live = _shadow_inputs(case)
    oargs = (case["pres"], _t(point.T), _t(dirs.T), _t(ldist), _t(skip), d)
    got += prk.occluded_transparent(*oargs)
    ref += prk.occluded_transparent_ref(*oargs)
    assert before == (prk.nearest_hit_transparent.launches,
                      prk.occluded_transparent.launches)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _one_chunk_pool(opacities):
    """A 3-D pool of one chunk: unit-ish triangles stacked along z at
    z = 1, 2, ..., all crossed by a ray along +z from the origin, with the
    given opacities."""
    n = len(opacities)
    d = 3
    p1 = np.zeros((n, d), np.float32)
    fn = np.zeros((n, d), np.float32)
    en = np.zeros((n, d - 1, d), np.float32)
    for i in range(n):
        # triangle (-1,-1,z), (3,-1,z), (-1,3,z): barycentric rows e1, e2
        p1[i] = (-1, -1, i + 1)
        fn[i] = (0, 0, 1)
        en[i, 0] = (-0.25, 0, 0)
        en[i, 1] = (0, -0.25, 0)
    dc = -(fn * p1).sum(axis=1).astype(np.float32)
    lo = np.tile(np.float32([-1, -1, 1]), (n, 1))
    hi = np.tile(np.float32([3, 3, n]), (n, 1))
    bins = [(lo.min(axis=0), hi.max(axis=0), list(range(n)))]
    res = prk.prepare_resident_cells(bins, p1, fn, en, dc, lo, hi, d)
    prk.add_opacity(res, np.asarray(opacities, np.float32))
    tens = {k: torch.from_numpy(np.asarray(v)) for k, v in res.items()}
    tens["n_eff"] = 1
    return tens


def test_filter_product_follows_the_lane_tree():
    """Three glass slots in one chunk: the halving tree multiplies lanes
    (0, 64), (1, 65), ... first, so slots 0, 1, 2 associate as
    (f0 * f2) * f1; a left-to-right product rounds differently, and the
    twin follows the tree."""
    f32 = np.float32
    ops = [f32(0.3), f32(0.7), f32(0.1)]
    f = [f32(1) - o for o in ops]
    tree = (f[0] * f[2]) * f[1]
    flat = (f[0] * f[1]) * f[2]
    assert tree != flat, "pick opacities whose products round apart"
    v = torch.ones(128)
    v[:3] = torch.tensor(f)
    assert prk._lane_tree_product(v).item() == tree
    res = _one_chunk_pool(ops)
    R = prk.RAY_BLOCK
    oT = torch.zeros((3, R))
    dT = torch.zeros((3, R))
    dT[2] = 1.0
    ldist = torch.full((R,), 10.0)
    ldist[1] = 2.5                      # only the first two surfaces
    ldist[2] = 0.0                      # inactive
    blocked, filt, vis = prk.occluded_transparent(
        res, oT, dT, ldist, torch.full((R,), -1, dtype=torch.int32), 3)
    assert not blocked.any() and vis.tolist() == [1]
    assert filt[0].item() == tree
    assert filt[1].item() == f[0] * f[1]
    assert filt[2].item() == 1.0
    # an opaque slot behind the glass blocks, and the filter is 1 there
    res = _one_chunk_pool(ops + [f32(1.0)])
    blocked, filt, _ = prk.occluded_transparent(
        res, oT, dT, ldist, torch.full((R,), -1, dtype=torch.int32), 3)
    assert blocked[0] and filt[0].item() == 1.0
    assert not blocked[1] and filt[1].item() == f[0] * f[1]


def test_slot_assignment_in_one_chunk():
    """Eleven glass surfaces in one chunk, K = 3: the chunk's hits are taken
    in ascending t, at most K of them, and fill slots 0, 1, 2 in that order;
    an opaque surface between them is the nearest hit, and slots are not
    trimmed by it in the walk."""
    ops = [0.5] * 11
    ops[1] = 1.0                        # z = 2 is opaque
    res = _one_chunk_pool(ops)
    R = prk.RAY_BLOCK
    oT = torch.zeros((3, R))
    dT = torch.zeros((3, R))
    dT[2] = 1.0
    t, slot, tt, ts, vis = prk.nearest_hit_transparent(
        res, oT, dT, torch.full((R,), -1, dtype=torch.int32), 3, 3)
    assert t[0].item() == 2.0 and slot[0].item() == 1
    assert tt[:, 0].tolist() == [1.0, 3.0, 4.0]
    assert ts[:, 0].tolist() == [0, 2, 3]
    assert vis.tolist() == [1]
    with pytest.raises(ValueError, match="1..8 slots"):
        prk.nearest_hit_transparent(
            res, oT, dT, torch.full((R,), -1, dtype=torch.int32), 3, 9)
    del res["opa"]
    with pytest.raises(ValueError, match="opacity row"):
        prk.nearest_hit_transparent(
            res, oT, dT, torch.full((R,), -1, dtype=torch.int32), 3, 3)


def test_dead_wavefronts(case):
    d = case["cfg"].d
    R = 2 * prk.RAY_BLOCK
    oT, dT = _t(case["o"][:R].T), _t(case["dirs"][:R].T)
    skip = torch.full((R,), -1, dtype=torch.int32)
    dead = torch.zeros(R, dtype=torch.bool)
    t, slot, tt, ts, vis = prk.nearest_hit_transparent(
        case["pres"], oT, dT, skip, d, 8, active=dead)
    assert not t.any() and (slot == -1).all() and (ts == -1).all()
    assert torch.isinf(tt).all() and not vis.any()
    blocked, filt, vis = prk.occluded_transparent(
        case["pres"], oT, dT, torch.zeros(R), skip, d)
    assert not blocked.any() and (filt == 1).all() and not vis.any()
