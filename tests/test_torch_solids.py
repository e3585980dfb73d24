"""Solids (CUBE and SPHERE) in ntracer_tpu_torch vs the JAX package and the
scalar oracle: ``_solid_test``, the solids' part of ``trace_pool`` and
``occlusion``, and whole frames.

The JAX side runs its Pallas walks in interpret mode (``jax_device_scene``).
Tolerances:

* ``_solid_test``: the miss mask exact; t, point and normal within the
  rounding bound of ``_solid_bounds`` (both engines' float32 sums of d
  products, propagated through the cube's division and the sphere's
  discriminant).
* ``trace_pool`` and ``occlusion``: pid, mat, every K slot id and
  ``blocked`` exact on rays that pass no solid silhouette within the
  bound's reach (``near`` of ``_solid_bounds``: a ray there may flip
  between hit and miss by one rounding); t within the bound; ``filt``
  within the product's rounding on unblocked rays.
* Frames against JAX: rtol 2e-6, atol 2e-7, except on pixels whose ray
  meets a sphere (its hit or a K slot): the JAX frame's program contracts
  the discriminant b*b - 4*a*c into an FMA, and the cancellation of the
  two terms (both about |o - centre|^2 / r^2 times the small difference)
  makes that a few 1e-5 of the color; there 1e-4, and the port equals the
  oracle.  Bytes within one code everywhere.
* Against the oracle: 5e-5 (5e-4 on composed pixels), on scenes whose
  solids are hand-built into one k-d leaf (``chip_smoke.leaf_scene``:
  PARITY.md defects 6 and 9).

Frames of solids alone and of a glass cube: tests/test_torch_solid_frames.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ntracer_tpu.engine import packing as jpack
from ntracer_tpu.engine import wavefront as jwf
import ntracer_tpu
import ntracer_tpu_torch
from ntracer_tpu_torch import BlockingRenderer, kdnodes
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import (JAX, PORT, _smoke, glass_solids_d3_scene,
                            jax_device_scene, rgb8, solids_d4_scene)
from test_torch_frame import _jax_frame_colors

U = 2.0 ** -24
W = H = 32

# the JAX package's occlusion query, jitted as its frame path jits it
_jax_occlusion = jax.jit(jwf.occlusion, static_argnames=("cfg", "clamp_exit"))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _solid_bounds(inv, orient, pos, stype, o, dv, t, d):
    """Per-ray bounds on the difference of two float32 evaluations of a
    solid's test (each sum of d products rounded its own way) for (R, d)
    rays ``o``/``dv`` and the hit distance ``t`` (R,): (t bound, point
    bound, normal bound, near), ``near`` where the test's hit-or-miss
    decision lies within the bound (a silhouette, a cube's edge, a start
    on the surface)."""
    inv, orient, pos = (np.asarray(v, np.float64) for v in (inv, orient, pos))
    o, dv = np.asarray(o, np.float64), np.asarray(dv, np.float64)
    g = 4 * (d + 2) * U                     # two engines, sums of d + 1
    to = o @ inv.T - pos
    td = dv @ inv.T
    e_to = g * (np.abs(o) @ np.abs(inv).T + np.abs(pos))
    e_td = g * (np.abs(dv) @ np.abs(inv).T)
    tf = np.where(np.isfinite(t), t, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        # the cube: every axis's candidate, each checked against the others
        near = np.zeros(len(o), bool)
        bt_axis = np.zeros_like(to)
        for i in range(d):
            ni = np.where(td[:, i] < 0, 1.0, -1.0)
            dist = (ni - to[:, i]) / td[:, i]
            bd = (e_to[:, i] + np.abs(dist) * e_td[:, i]) / np.abs(td[:, i]) \
                + 4 * U * np.abs(dist)
            bt_axis[:, i] = bd
            p = to + dist[:, None] * td
            ep = e_to + np.abs(dist)[:, None] * e_td \
                + np.abs(td) * bd[:, None] + 2 * U * np.abs(p)
            # the face is met, or missed, within the bound of its edges
            reach = np.abs(p) <= 1 + 4 * ep + 4 * U
            edge = np.abs(np.abs(p) - 1) <= 4 * ep + 4 * U
            reach[:, i], edge[:, i] = True, False
            near_i = (dist > -4 * bd) & reach.all(axis=1) \
                & (edge.any(axis=1) | (np.abs(dist) <= 4 * bd))
            if stype == 1:
                near |= near_i & np.isfinite(dist)
        if stype == 1:
            axis = np.argmin(np.abs(np.abs(to + tf[:, None] * td) - 1)
                             + np.where(np.abs(td) > 0, 0, np.inf), axis=1)
            bt = np.take_along_axis(bt_axis, axis[:, None], 1)[:, 0]
        else:
            a = (td * td).sum(axis=1)
            b = 2 * (td * to).sum(axis=1)
            c = (to * to).sum(axis=1) - 1
            disc = b * b - 4 * a * c
            e_a = 2 * (np.abs(td) * e_td).sum(axis=1) + g * a
            e_b = 2 * ((np.abs(td) * e_to).sum(axis=1)
                       + (np.abs(to) * e_td).sum(axis=1)) + g * np.abs(b)
            e_c = 2 * (np.abs(to) * e_to).sum(axis=1) + g * (c + 2)
            e_disc = 2 * np.abs(b) * e_b + 4 * (a * e_c + np.abs(c) * e_a) \
                + 8 * U * (b * b + 4 * np.abs(a * c))
            sq = np.sqrt(np.maximum(disc, 0))
            bt = e_b * (1 + np.abs(b) / sq) / (2 * a) \
                + e_disc / (4 * a * sq) + np.abs(tf) * e_a / a \
                + 8 * U * np.abs(tf)
            near = (np.abs(disc) <= 4 * e_disc) \
                | (np.abs((-b - sq) / (2 * a)) <= 4 * bt) & (disc > 0)
    # a miss has no distance to bound; a hit without a finite bound is near
    near |= np.isfinite(t) & ~np.isfinite(bt)
    bt = np.where(np.isfinite(t) & np.isfinite(bt), bt, 0.0)
    p_obj = to + tf[:, None] * td
    e_p = e_to + np.abs(tf)[:, None] * e_td \
        + np.abs(td) * bt[:, None] + 2 * U * np.abs(p_obj)
    bp = (e_p + g * np.abs(p_obj + pos)) @ np.abs(orient).T
    bn = np.zeros_like(bp) if stype == 1 \
        else (e_p + g * np.abs(p_obj)) @ np.abs(orient).T
    return 2 * bt, 2 * bp.max(axis=1), 2 * bn.max(axis=1), near


def _rotation(d, rng):
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return q


@pytest.mark.parametrize("kind", ["cube", "sphere"])
@pytest.mark.parametrize("d", [3, 4, 6, 10])
def test_solid_test_matches_jax(d, kind):
    """A solid under a rotated, unevenly scaled orientation against seeded
    rays: a quarter start inside it (and miss it), the rest aim near it
    from outside."""
    stype = _smoke().CUBE if kind == "cube" else _smoke().SPHERE
    assert (stype == ntracer_tpu_torch.CUBE == ntracer_tpu.CUBE
            if kind == "cube" else
            stype == ntracer_tpu_torch.SPHERE == ntracer_tpu.SPHERE)
    rng = np.random.RandomState(10 * d + stype)
    orient = (_rotation(d, rng) @ np.diag(rng.uniform(0.5, 1.5, d))) \
        .astype(np.float32)
    inv = np.linalg.inv(orient.astype(np.float64)).astype(np.float32)
    pos = rng.uniform(-0.5, 0.5, d).astype(np.float32)
    centre = pos.astype(np.float64) @ orient.T.astype(np.float64)
    R = 4096
    o = centre + rng.normal(size=(R, d)) * 3
    # inside: within 0.25 of the centre on every axis of the solid's frame
    o[:R // 4] = (pos + rng.uniform(-0.25, 0.25, (R // 4, d))) \
        @ orient.T.astype(np.float64)
    dv = centre + rng.normal(size=(R, d)) * 0.8 - o
    dv[:R // 4] = rng.normal(size=(R // 4, d))
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    o, dv = o.astype(np.float32), dv.astype(np.float32)
    arrs = dict(sol_type=np.array([stype], np.int32), sol_orient=orient[None],
                sol_inv=inv[None], sol_pos=pos[None])

    jt, jp, jn = (np.asarray(v) for v in jwf._solid_test(
        {k: jnp.asarray(v) for k, v in arrs.items()}, 0, jnp.asarray(o),
        jnp.asarray(dv), d))
    pt, pp, pn = (v.numpy() for v in pwf._solid_test(
        {k: _t(v) for k, v in arrs.items()}, 0, _t(o.T), _t(dv.T), d))
    assert pt.shape == (R,) and pp.shape == pn.shape == (d, R)
    hit = np.isfinite(jt)
    assert np.array_equal(np.isfinite(pt), hit)
    # a ray that starts inside meets no near face ahead of it: every
    # engine (and the reference) lets it out unhit
    assert not hit[:R // 4].any() and hit[R // 4:].sum() > 16
    assert (pt[hit] > 0).all() and (pt[~hit] == np.inf).all()
    bt, bp, bn, _near = _solid_bounds(inv, orient, pos, stype, o, dv, jt, d)
    assert (np.abs(pt - jt) <= bt)[hit].all()
    assert (np.abs(pp - jp.T).max(axis=0) <= bp)[hit].all()
    assert (np.abs(pn - jn.T).max(axis=0) <= bn)[hit].all()
    if kind == "cube":
        # the normal is the orientation's image of a face's axis, exactly
        assert np.array_equal(pn[:, hit], jn.T[:, hit])


SCENES = {"solids_d4": solids_d4_scene,
          "glass_solids_d3": glass_solids_d3_scene}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    """Both packages' scenes from one seed, the JAX device scene (Pallas
    layouts) and the port's, the rays of a 64x64 frame (one dispatch group)
    and both engines' primary traces."""
    mp = pytest.MonkeyPatch()
    jscene = SCENES[request.param](JAX)
    pscene = SCENES[request.param](PORT)
    jcfg, arrs, _ = jax_device_scene(jscene, mp)
    jdev = jwf.get_device_scene(jscene)[1]
    mp.undo()
    pcfg, parrs, _ = pwf.get_device_scene(pscene, "cpu")
    assert pcfg == pwf.SceneConfig(**{k: v for k, v in vars(jcfg).items()
                                      if k != "prim_axis"})
    assert pcfg.n_solids == 2 and pcfg.shadows
    n = 64
    pscene._set_view_size(n, n)
    fov = pwf._fov_params(n, n, pscene.fov)
    xs, ys, _ = pwf._ray_coords(0, n, pwf.TILE, "cpu")
    cam_o = np.asarray(pscene._cam._origin, np.float32)
    cam_t = np.asarray(pscene._cam._t, np.float32)
    oT, dT = pwf.make_rays(_t(cam_o), _t(cam_t), *fov, xs, ys)
    skip = torch.full((oT.shape[1],), -1, dtype=torch.int32)
    hit = pwf.trace_pool(parrs, pcfg, oT, dT, skip, shared_origin=_t(cam_o))
    jhit = jwf.trace_pool(jdev, jcfg, jnp.asarray(oT.numpy().T),
                          jnp.asarray(dT.numpy().T), jnp.asarray(skip.numpy()),
                          shared_origin=jnp.asarray(cam_o), transposed=True)
    return dict(name=request.param, pcfg=pcfg, jcfg=jcfg, parrs=parrs,
                arrs=arrs, jdev=jdev, oT=oT, dT=dT, hit=hit,
                jhit={k: np.asarray(v) for k, v in jhit.items()})


def _near_solids(arrs, o, dv, d, n_solids, skip=None):
    """Rays (R,) that pass a solid's silhouette within the rounding bound
    (the solid each ray leaves, ``skip``, aside), and the per-solid (t, t
    bound) of the JAX package's test."""
    near = np.zeros(len(o), bool)
    tb = []
    for s in range(n_solids):
        args = (arrs["sol_inv"][s], arrs["sol_orient"][s], arrs["sol_pos"][s],
                int(arrs["sol_type"][s]))
        st = np.asarray(jwf._solid_test({k: jnp.asarray(v)
                                          for k, v in arrs.items()}, s,
                                         jnp.asarray(o), jnp.asarray(dv),
                                         d)[0])
        bt, _bp, _bn, ns = _solid_bounds(*args, o, dv, st, d)
        near |= ns if skip is None else ns & (skip != arrs["sol_base"] + s)
        tb.append((st, bt))
    return near, tb


def _tri_t_bound(o, dirs, ids, arrs, d):
    """Per-ray bound on the rounding of the triangle ``ids``' t = -(o.fn +
    dc) / (dirs.fn), summed over both engines' evaluations."""
    s = np.clip(ids, 0, len(arrs["tri_fn"]) - 1)
    fn = arrs["tri_fn"][s].astype(np.float64)
    dc = arrs["tri_dc"][s].astype(np.float64)
    on = np.abs(o * fn).sum(axis=1)
    dn = np.abs(dirs * fn).sum(axis=1)
    denom = np.abs((dirs * fn).sum(axis=1))
    t = np.abs(((o * fn).sum(axis=1) + dc) / denom)
    return 4 * (d + 2) * U * 2 * ((np.abs(dc) + on) / denom + t * dn / denom)


def _t_bound(case, o, dirs, ids, tb):
    """The rounding bound of each ray's t (R,) for the winner ``ids``: a
    triangle's numerator bound or the solid's."""
    cfg = case["pcfg"]
    bound = _tri_t_bound(o, dirs, ids, case["arrs"], cfg.d)
    for s, (_st, bt) in enumerate(tb):
        bound = np.where(ids == cfg.n_tris + s, bt, bound)
    return bound


def test_device_arrays_hold_the_solids(case):
    """The solid rows and ``sol_base`` equal the JAX package's arrays."""
    for k in ("sol_type", "sol_orient", "sol_inv", "sol_pos", "sol_mat",
              "sol_base", "mat_pack"):
        got, want = case["parrs"][k], case["arrs"][k]
        assert got.dtype == torch.from_numpy(np.asarray(want)).dtype, k
        assert np.array_equal(got.numpy(), want), k
    assert int(case["parrs"]["sol_base"]) == case["pcfg"].n_tris


def test_trace_pool_matches_jax(case):
    """The nearest hit (pid, mat exact, t within the bound, point and
    normal of solid hits) and, with glass, every K slot (ids, materials
    exact, t within the bound) on rays off the solids' silhouettes."""
    cfg, hit, ref = case["pcfg"], case["hit"], case["jhit"]
    d = cfg.d
    o, dirs = case["oT"].numpy().T, case["dT"].numpy().T
    near, tb = _near_solids(case["arrs"], o, dirs, d, cfg.n_solids)
    got = {k: v.numpy() for k, v in hit.items()}
    off = ~near
    print(f"{case['name']}: {int(near.sum())} of {len(near)} rays pass a "
          f"silhouette within the bound")
    assert near.sum() < 0.01 * len(near)
    assert np.array_equal(got["pid"][off], ref["pid"][off])
    assert np.array_equal(got["mat"][off], ref["mat"][off])
    solid = got["pid"] >= cfg.n_tris
    assert solid[off].sum() > 200
    h = off & (got["pid"] >= 0)
    bound = _t_bound(case, o, dirs, got["pid"], tb)
    assert (np.abs(got["t"] - ref["t"]) <= 1e-6 * ref["t"] + bound)[h].all()
    # the solids' hit points and normals (the triangles' are the walks')
    for s in range(cfg.n_solids):
        sel = off & (got["pid"] == cfg.n_tris + s)
        _st, _bt = tb[s]
        args = (case["arrs"]["sol_inv"][s], case["arrs"]["sol_orient"][s],
                case["arrs"]["sol_pos"][s], int(case["arrs"]["sol_type"][s]))
        _b, bp, bn, _n = _solid_bounds(*args, o, dirs, ref["t"], d)
        assert (np.abs(got["pointT"] - ref["pointT"]).max(axis=0)
                <= bp)[sel].all()
        assert (np.abs(got["normalT"] - ref["normalT"]).max(axis=0)
                <= bn)[sel].all()
    if "tidT" not in got:
        assert not cfg.has_transparency
        return
    K = cfg.max_transparent_hits
    assert got["tidT"].shape == (K, len(near))
    assert np.array_equal(got["tidT"][:, off], ref["tidT"][:, off])
    valid = (got["tidT"] >= 0) & off[None, :]
    glass_solid = valid & (got["tidT"] >= cfg.n_tris)
    print(f"{case['name']}: {int(valid.sum())} valid slots, "
          f"{int(glass_solid.sum())} of them a solid's")
    assert glass_solid.sum() > 50 and (valid & ~glass_solid).sum() > 50
    assert np.array_equal(got["tmatT"][valid], ref["tmatT"][valid])
    for k in range(K):
        m = valid[k]
        b = _t_bound(case, o, dirs, got["tidT"][k], tb)
        assert (np.abs(got["ttT"][k] - ref["ttT"][k])
                <= 1e-6 * np.abs(ref["ttT"][k]) + b)[m].all()
    np.testing.assert_allclose(got["tnormT"][:, valid],
                               ref["tnormT"][:, valid], rtol=1e-5, atol=1e-5)
    # slots sorted ascending, all in front of the opaque hit
    tt = np.where(valid, got["ttT"], np.inf)
    assert (np.diff(tt, axis=0)[valid[1:]] >= 0).all()
    assert (tt[valid] < np.broadcast_to(got["t"], tt.shape)[valid]).all()


def _shadow_query(case, light):
    """The shadow query of ``light`` ("point" or "global") from the opaque
    hits, as ``shade_local_T`` casts it: (origins, directions, ldist, skip,
    clamp_exit)."""
    hit, arrs = case["hit"], case["parrs"]
    act = hit["hit"]
    pointT = torch.where(act[None, :], hit["pointT"], 0.0)
    if light == "point":
        lv = pointT - arrs["pl_pos"][0][:, None]
        dist = pwf.rk._sqrt(pwf._dotT(lv, lv))
        return (pointT, (lv / dist[None, :]).contiguous(),
                torch.where(act, dist, 0.0), hit["pid"], False)
    ld = (-arrs["gl_dir"][0])[:, None].expand_as(pointT).contiguous()
    return pointT, ld, torch.where(act, pwf.REAL_MAX, 0.0), hit["pid"], True


def test_occlusion_matches_jax(case):
    """Every light's shadow query from the opaque hits: ``blocked`` exact
    off the silhouettes (solids block against the unclamped ``ldist``),
    ``filt`` within the rounding of its product on unblocked rays, and the
    solids change the answer."""
    cfg = case["pcfg"]
    lights = ["point"] * cfg.n_point_lights + ["global"] * cfg.n_global_lights
    assert lights
    met = 0
    for light in lights:
        pointT, lv, ldist, pid, clamp = _shadow_query(case, light)
        pb, pf = pwf.occlusion(case["parrs"], cfg, pointT, lv, ldist, pid,
                               clamp_exit=clamp)
        jb, jf = _jax_occlusion(case["jdev"], case["jcfg"],
                                jnp.asarray(pointT.numpy().T),
                                jnp.asarray(lv.numpy().T),
                                jnp.asarray(ldist.numpy()),
                                jnp.asarray(pid.numpy()), clamp_exit=clamp)
        pb, jb, jf = pb.numpy(), np.asarray(jb), np.asarray(jf)
        o, dirs = pointT.numpy().T, lv.numpy().T
        near, tb = _near_solids(case["arrs"], o, dirs, cfg.d, cfg.n_solids,
                                skip=pid.numpy())
        live = ldist.numpy() > 0
        off = ~near
        assert np.array_equal(pb[off], jb[off])
        assert near[live].sum() < 0.01 * live.sum()
        # the solids' own share: rays that meet a solid before the light
        by_solid = np.zeros_like(pb)
        for s, (st, _bt) in enumerate(tb):
            by_solid |= (st > 0) & (st < ldist.numpy()) & live \
                & (pid.numpy() != cfg.n_tris + s)
        print(f"{case['name']} {light}: {int(live.sum())} queries, "
              f"{int(pb.sum())} blocked, {int(by_solid.sum())} meet a solid")
        met += int((by_solid & off).sum())
        if pf is None:
            assert not cfg.has_transparency
            continue
        pf = pf.numpy()
        ub = off & ~pb
        # at most a few dozen factors: within 2 x 32 roundings
        np.testing.assert_allclose(pf[ub], jf[ub], rtol=64 * U, atol=0)
        assert ((pf < 1) & ub).sum() > 5
    assert met > 5


def _sphere_pixels(pscene, n, k=True):
    """Pixels (n, n) whose primary ray meets a sphere: its opaque hit or,
    with ``k``, one of its K slots (port's primary trace)."""
    cfg, arrs, _ = pwf.get_device_scene(pscene, "cpu")
    pscene._set_view_size(n, n)
    fov = pwf._fov_params(n, n, pscene.fov)
    groups = pwf._frame_groups(-(-(n * n) // pwf.TILE))
    xs, ys, unswz = pwf._frame_coords(groups, n, "cpu")
    cam_o = _t(np.asarray(pscene._cam._origin, np.float32))
    oT, dT = pwf.make_rays(cam_o, _t(np.asarray(pscene._cam._t, np.float32)),
                           *fov, xs, ys)
    res = pwf.trace_pool(arrs, cfg, oT, dT,
                         torch.full((oT.shape[1],), -1, dtype=torch.int32),
                         shared_origin=cam_o)
    meets = torch.zeros_like(res["hit"])
    for s in range(cfg.n_solids):
        if int(arrs["sol_type"][s]) == _smoke().SPHERE:
            sid = cfg.n_tris + s
            meets |= res["pid"] == sid
            if k and "tidT" in res:
                meets |= (res["tidT"] == sid).any(dim=0)
    return unswz(meets)[:n * n].numpy().reshape(n, n)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_frame_matches_jax_and_oracle(name, monkeypatch):
    jscene = SCENES[name](JAX)
    pscene = SCENES[name](PORT)
    jax_device_scene(jscene, monkeypatch)
    ref = _jax_frame_colors(jscene, W, H)
    got, masks = pwf.frame_colors(pscene, W, H, "cpu", masks=True)
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    sphere = _sphere_pixels(pscene, W)
    close = np.isclose(got, ref, rtol=2e-6, atol=2e-7).all(axis=2)
    print(f"{name}: {int(sphere.sum())} pixels meet a sphere, "
          f"{int((~close).sum())} beyond rtol 2e-6, "
          f"{int((~close & ~sphere).sum())} of them elsewhere")
    assert close[~sphere].all()
    assert np.abs(got - ref)[sphere].max(initial=0) <= 1e-4
    assert masks["hit"].sum() > 100 and masks["shadowed"].sum() > 5
    if "glass" in name:
        assert masks["layered"].sum() > 50 and masks["filtered"].any()

    # packed bytes through the port's renderer: within one code of JAX's
    fmt = rgb8(W, H)
    buf = bytearray(fmt.pitch * H)
    assert BlockingRenderer(device="cpu").render(buf, fmt, pscene)
    ref_bytes = np.asarray(jpack.pack_device(
        jnp.asarray(ref.reshape(-1, 3)), jpack.format_key(fmt)))
    diff = np.abs(np.frombuffer(bytes(buf), np.uint8).astype(int)
                  - ref_bytes.reshape(-1).astype(int))
    assert diff.max() <= 1

    # the oracle (exact occlusion walk) at sphere pixels and others; a
    # glass scene's pixels hold fewer than K glass surfaces
    monkeypatch.setattr(kdnodes, "OCCLUDES_EARLY_OUT", False)
    pscene._set_view_size(W, H)
    rng = np.random.RandomState(2)
    pixels = []
    for mask, n in ((sphere, 12), (masks["hit"], 12), (masks["shadowed"], 4)):
        ys_, xs_ = np.nonzero(mask & ~masks["full"])
        pixels += [(int(xs_[i]), int(ys_[i]))
                   for i in rng.choice(len(xs_), n)]
    worst = max(float(np.abs(pscene._pixel_color(x, y) - got[y, x]).max())
                for x, y in pixels)
    assert worst < (5e-4 if "glass" in name else 5e-5), worst
