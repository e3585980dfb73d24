"""Scenes with transparent materials: ntracer_tpu_torch vs the JAX package
and the scalar oracle, from the trace's K slots to whole frames.

Both engines shade the same scene (the JAX package's device scene, as numpy
arrays, becomes the port's tensors) from the same rays; the JAX side runs its
Pallas walks in interpret mode.  Scenes are built unbatched (see
``_torch_helpers.unbatched``): the oracle records one transparent hit per
triangle batch per leaf, so only then does it keep every glass surface, as
the engines do.

Tolerance.  Against JAX: colors to rtol 2e-6, atol 2e-7 and bytes within one
code.  The rays beyond that are counted and must stay under 0.2% of the
frame: ``want``, ``blocked`` and ``filt`` of every light, slot and bounce are
logged, and the ulps between XLA's FMA contraction and the port's strict
rounding can flip one at a shadow edge; a ray whose queries all agree may
still miss atol 2e-7 where a grazing dot product cancels, and is held to
atol 2e-6.  Against the oracle: 5e-4 (tests/test_engine.py's tolerance for
composed pixels), on pixels whose rays found fewer than K glass surfaces (a
ray that crosses more keeps only the K nearest, the oracle all of them).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu.engine import packing as jpack
from ntracer_tpu_torch import BlockingRenderer, NTracer, CUBE, Material, \
    ImageFormat, Channel, kdnodes
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import (JAX, PORT, glass_scene, polytope_scene,
                            random_scene, rgb8, unbatched, jax_device_scene)
from test_torch_resident import _t_rounding_bound

W = H = 64
MAX_FLIPS = int(0.002 * W * H)          # 0.2% of the frame: 8 pixels

# The JAX package's occlusion query, jitted as its frame path jits it: run
# eagerly, its lax.cond would compile the interpreted Pallas walk anew for
# every light, slot and bounce.
_jax_occlusion = jax.jit(jwf.occlusion, static_argnames=("cfg", "clamp_exit"))


SCENES = {
    "3d_glass_lit": lambda pkg: glass_scene(300, lit=True, pkg=pkg),
    "3d_glass_reflective": lambda pkg: glass_scene(
        200, seed=21, spread=0.8, lit=True, reflectivity=0.4, pkg=pkg),
    "4d_glass_600cell": lambda pkg: polytope_scene(glass=True, lit=True,
                                                   pkg=pkg),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    """Both packages' scenes from one seed (unbatched), the JAX device scene
    as the port's tensors, the frame's rays and the port's primary trace."""
    mp = pytest.MonkeyPatch()
    with unbatched(JAX):
        jscene = SCENES[request.param](JAX)
    with unbatched(PORT):
        pscene = SCENES[request.param](PORT)
    if "reflective" in request.param:
        for s in (jscene, pscene):
            s.set_max_reflect_depth(1)
    jcfg, arrs, _ = jax_device_scene(jscene, mp)
    jdev = jwf.get_device_scene(jscene)[1]
    mp.undo()
    pcfg, parrs, _ = pwf.get_device_scene(pscene, "cpu")
    assert pcfg == pwf.SceneConfig(**{k: v for k, v in vars(jcfg).items()
                                      if k != "prim_axis"})
    assert pcfg.has_transparency and pcfg.shadows
    tens = pwf.tensors_from_arrays(arrs, "cpu")
    for k in ("mat_pack", "res_opa", "res_slot_pack", "res_ids"):
        assert torch.equal(tens[k], parrs[k]), k
    pscene._set_view_size(W, H)
    fov = pwf._fov_params(W, H, pscene.fov)
    groups = pwf._frame_groups(-(-(W * H) // pwf.TILE))
    xs, ys, unswz = pwf._frame_coords(groups, W, "cpu")
    cam_o = np.asarray(pscene._cam._origin, np.float32)
    cam_t = np.asarray(pscene._cam._t, np.float32)
    # the frame's own rays: the dispatch group pads them to 32768
    oT, dT = pwf.make_rays(_t(cam_o), _t(cam_t), *fov, xs[:W * H],
                           ys[:W * H])
    R = oT.shape[1]
    hit = pwf.trace_pool(tens, pcfg, oT, dT,
                         torch.full((R,), -1, dtype=torch.int32),
                         shared_origin=_t(cam_o))
    return dict(name=request.param, jscene=jscene, pscene=pscene, jcfg=jcfg,
                pcfg=pcfg, jdev=jdev, tens=tens, arrs=arrs, unswz=unswz,
                cam_o=cam_o, oT=oT, dT=dT, hit=hit,
                jdyn=jwf._scene_dyn(jscene),
                pdyn=pwf._scene_dyn(pscene, "cpu"))


def _jax_trace(case):
    oT, dT = case["oT"], case["dT"]
    return jwf.trace_pool(
        case["jdev"], case["jcfg"], jnp.asarray(oT.numpy().T),
        jnp.asarray(dT.numpy().T), jnp.full((oT.shape[1],), -1, jnp.int32),
        shared_origin=jnp.asarray(case["cam_o"]), transposed=True)


def test_trace_pool_slots_match_jax(case):
    """The K outputs of ``trace_pool``: ids exact and in the same (sorted)
    positions, distances within the rounding bound, materials and normals of
    the valid slots, and the trim by the opaque hit."""
    pcfg, hit = case["pcfg"], case["hit"]
    K, d = pcfg.max_transparent_hits, pcfg.d
    ref = {k: np.asarray(v) for k, v in _jax_trace(case).items()}
    got = {k: v.numpy() for k, v in hit.items()}
    assert got["ttT"].shape == got["tidT"].shape == got["tmatT"].shape \
        == (K, hit["t"].shape[0])
    assert got["tnormT"].shape == (d, K, hit["t"].shape[0])
    assert np.array_equal(got["pid"], ref["pid"])
    assert np.array_equal(got["tidT"], ref["tidT"])
    valid = got["tidT"] >= 0
    assert valid.sum() > 200 and got["hit"].sum() > 100
    assert np.array_equal(got["tmatT"][valid], ref["tmatT"][valid])
    np.testing.assert_allclose(got["tnormT"][:, valid],
                               ref["tnormT"][:, valid], rtol=2e-6, atol=2e-7)
    o, dirs = case["oT"].numpy().T, case["dT"].numpy().T
    # pool id -> slot, for the rounding bound of each slot's pair test
    ids = case["arrs"]["res_ids"][:, 0, :].reshape(-1)
    slot_of = np.full(ids.max() + 2, 0)
    slot_of[ids[ids >= 0]] = np.nonzero(ids >= 0)[0]
    for k in range(K):
        m = valid[k]
        bound = _t_rounding_bound(o, dirs, slot_of[got["tidT"][k]],
                                  case["arrs"], d)
        assert (np.abs(got["ttT"][k] - ref["ttT"][k])
                <= 1e-6 * np.abs(ref["ttT"][k]) + bound)[m].all()
    # sorted ascending, and every valid slot lies in front of the opaque hit
    tt = np.where(valid, got["ttT"], np.inf)
    assert (got["ttT"][1:] >= got["ttT"][:-1]).all()
    assert (tt[valid] < np.broadcast_to(got["t"], tt.shape)[valid]).all()
    # the trim does remove something: a glass surface behind an opaque hit
    raw = pwf.rk.nearest_hit_transparent(
        pwf._res_dict(case["tens"]), case["oT"], case["dT"],
        torch.full_like(hit["pid"], -1), d, K,
        order=pwf.primary_ctx(case["tens"], pcfg, _t(case["cam_o"]))["order"])
    assert int((raw[3] >= 0).sum()) > int(valid.sum())


def _shadow_query(case, k):
    """The point light's shadow query from the hits of slot ``k`` (or the
    opaque hits, k = None), as ``shade_local_T`` makes it."""
    hit, tens, dT = case["hit"], case["tens"], case["dT"]
    if k is None:
        pointT, nT, pid, act = (hit["pointT"], hit["normalT"], hit["pid"],
                                hit["hit"])
    else:
        act = hit["tidT"][k] >= 0
        pointT = case["oT"] + hit["ttT"][k][None, :] * dT
        nT, pid = hit["tnormT"][:, k], torch.where(act, hit["tidT"][k], 0)
    pointT = torch.where(act[None, :], pointT, 0.0)
    lv = pointT - tens["pl_pos"][0][:, None]
    dist = pwf.rk._sqrt(pwf._dotT(lv, lv))
    lv = lv / dist[None, :]
    want = act & (pwf._dotT(nT, lv) > 0)
    return pointT, lv.contiguous(), torch.where(want, dist, 0.0), pid, want


@pytest.mark.parametrize("k", [None, 0])
def test_occlusion_returns_blocked_and_filter(case, k):
    pointT, lv, ldist, pid, want = _shadow_query(case, k)
    pb, pf = pwf.occlusion(case["tens"], case["pcfg"], pointT, lv, ldist, pid,
                           clamp_exit=False)
    jb, jf = _jax_occlusion(case["jdev"], case["jcfg"],
                            jnp.asarray(pointT.numpy().T),
                            jnp.asarray(lv.numpy().T),
                            jnp.asarray(ldist.numpy()),
                            jnp.asarray(pid.numpy()), clamp_exit=False)
    pb, pf, jb, jf = pb.numpy(), pf.numpy(), np.asarray(jb), np.asarray(jf)
    assert pb.dtype == np.bool_ and pf.dtype == np.float32
    assert np.array_equal(pb, jb)
    assert np.array_equal(pf[~pb], jf[~pb])
    assert (pf[pb] == 1).all() and not pb[~want.numpy()].any()
    print(f"{case['name']} k={k}: {int(want.sum())} queries, "
          f"{int(pb.sum())} blocked, {int(((pf < 1) & ~pb).sum())} filtered")
    assert int(want.sum()) > 50
    if "600cell" not in case["name"]:
        # (a convex body's front faces look at their lights unhindered)
        assert ((pf < 1) & ~pb).any()


def test_compose_transparent_T_matches_jax(case, monkeypatch):
    """Both packages' composition on identical inputs: the port's trace
    result over a seeded base color."""
    hit, pcfg = case["hit"], case["pcfg"]
    R = hit["t"].shape[0]
    monkeypatch.setattr(jwf, "occlusion", _jax_occlusion)
    rng = np.random.RandomState(4)
    base = rng.uniform(0, 1, (3, R)).astype(np.float32)
    got_c, got_w = pwf._compose_transparent_T(
        case["tens"], pcfg, case["pdyn"], case["oT"], case["dT"], hit,
        _t(base), 0)
    jres = {k: jnp.asarray(hit[k].numpy())
            for k in ("tidT", "ttT", "tnormT", "tmatT")}
    ref_c, ref_w = jwf._compose_transparent_T(
        case["jdev"], case["jcfg"], case["jdyn"],
        jnp.asarray(case["oT"].numpy()), jnp.asarray(case["dT"].numpy()),
        jres, jnp.asarray(base), 0)
    close = np.isclose(got_c.numpy(), np.asarray(ref_c), rtol=2e-6,
                       atol=2e-7).all(axis=0)
    print(f"{case['name']}: {int((~close).sum())} rays beyond tolerance")
    assert (~close).sum() <= MAX_FLIPS
    assert np.array_equal(got_w.numpy(), np.asarray(ref_w))
    layered = (hit["tidT"] >= 0).any(dim=0).numpy()
    assert (got_w.numpy()[layered] < 1).all()
    assert (got_w.numpy()[~layered] == 1).all()
    assert np.array_equal(got_c.numpy()[:, ~layered], base[:, ~layered])


def _record(monkeypatch, mod, log, to_np):
    """Log every shadow query of ``mod``'s engine: (wanted, blocked, filt);
    an opaque scene of the port has no ``filt`` (None), logged as 1."""
    inner = _jax_occlusion if mod is jwf else mod.occlusion

    def occlusion(arrs, cfg, o, dirs, ldist, skip, **kw):
        blocked, filt = inner(arrs, cfg, o, dirs, ldist, skip, **kw)
        log.append((to_np(ldist) > 0, to_np(blocked),
                    np.float32(1) if filt is None else to_np(filt)))
        return blocked, filt

    monkeypatch.setattr(mod, "occlusion", occlusion)


def _flips(jlog, plog):
    """Rays on which any shadow query's outcome differs between the
    engines."""
    assert len(jlog) == len(plog) > 0
    flip = np.zeros_like(jlog[0][0])
    for (jw, jb, jf), (pw, pb, pf) in zip(jlog, plog):
        ok = pw & ~pb
        flip |= (jw != pw) | ((jb & jw) != (pb & pw)) \
            | (ok & ~np.isclose(jf, pf, rtol=1e-6, atol=0))
    return flip


def test_glass_frame_matches_jax_and_oracle(case, monkeypatch):
    jlog, plog = [], []
    _record(monkeypatch, jwf, jlog, np.asarray)
    _record(monkeypatch, pwf, plog, lambda x: x.numpy())
    tens, pcfg = case["tens"], case["pcfg"]
    oT, dT = case["oT"], case["dT"]
    got = pwf._ray_colors_T(tens, pcfg, case["pdyn"], oT, dT).numpy()
    pctx = jwf.primary_ctx(case["jdev"], case["jcfg"],
                           jnp.asarray(case["cam_o"]))
    ref = np.asarray(jwf._ray_colors_T(
        case["jdev"], case["jcfg"], case["jdyn"], jnp.asarray(oT.numpy().T),
        jnp.asarray(dT.numpy().T), False, pctx, want_T=True))
    monkeypatch.undo()
    bounces = pcfg.max_reflect_depth if pcfg.has_reflectivity else 0
    n_lights = pcfg.n_point_lights + pcfg.n_global_lights
    K = pcfg.max_transparent_hits
    assert len(plog) == len(jlog) == n_lights * (K + 1) * (bounces + 1)
    flips = _flips(jlog, plog)
    n_flips = int(flips.sum())
    filtered = sum(int((w & ~b & (f < 1)).sum()) for w, b, f in plog)
    shadowed = sum(int((w & b).sum()) for w, b, f in plog)
    print(f"{case['name']}: {n_flips} of {W * H} pixels with a differing "
          f"shadow query; {shadowed} blocked and {filtered} filtered queries")
    assert shadowed > 0 and filtered > 0
    assert np.isfinite(got).all()
    close = np.isclose(got, ref, rtol=2e-6, atol=2e-7).all(axis=0)
    print(f"{case['name']}: {int((~close).sum())} pixels beyond tolerance, "
          f"{int((~close & ~flips).sum())} of them outside the logged flips")
    assert (flips | ~close).sum() <= MAX_FLIPS
    # outside the flips a ray beyond tolerance is a grazing dot product's
    # cancellation (absolute error of a few 1e-7 on a dark pixel), not a
    # different surface or light
    np.testing.assert_allclose(got[:, ~flips], ref[:, ~flips], rtol=2e-6,
                               atol=2e-6)
    flips = flips | ~close

    # the whole frame through the port's frame path and its renderer
    pframe, masks = pwf.frame_colors(case["pscene"], W, H, "cpu", masks=True)
    np.testing.assert_array_equal(
        pframe.reshape(-1, 3), case["unswz"](_t(np.pad(
            got.T, ((0, pwf.TILE - W * H), (0, 0))))).numpy()[:W * H])
    fmt = rgb8(W, H)
    buf = bytearray(fmt.pitch * H)
    assert BlockingRenderer(device="cpu").render(buf, fmt, case["pscene"])
    jframe = case["unswz"](_t(np.pad(
        ref.T, ((0, pwf.TILE - W * H), (0, 0))))).numpy()[:W * H]
    ref_bytes = np.asarray(jpack.pack_device(
        jnp.asarray(jframe), jpack.format_key(fmt))).reshape(H, W, 3)
    diff = np.abs(np.frombuffer(bytes(buf), np.uint8).astype(int)
                  .reshape(H, W, 3) - ref_bytes.astype(int))
    frame_flips = case["unswz"](_t(np.pad(flips, (0, pwf.TILE - W * H)))) \
        .numpy()[:W * H].reshape(H, W)
    assert diff[~frame_flips].max() <= 1

    # the scalar oracle (exact occlusion walk) at seeded pixels whose rays
    # hold fewer than K glass surfaces
    monkeypatch.setattr(kdnodes, "OCCLUDES_EARLY_OUT", False)
    full, layered = masks["full"], masks["layered"]
    pscene = case["pscene"]
    pscene._set_view_size(W, H)
    rng = np.random.RandomState(1)
    ys_, xs_ = np.nonzero(layered & ~full)
    picks = rng.choice(len(xs_), size=min(32, len(xs_)), replace=False)
    pixels = [(int(xs_[i]), int(ys_[i])) for i in picks]
    pixels += [(int(rng.randint(W)), int(rng.randint(H))) for _ in range(16)]
    pixels = [(x, y) for x, y in pixels if not full[y, x]]
    over = []
    for x, y in pixels:
        diff = float(np.abs(pscene._pixel_color(x, y) - pframe[y, x]).max())
        if diff >= 5e-4:
            over.append((x, y, diff))
    print(f"{case['name']}: {len(pixels)} oracle pixels ({int(full.sum())} "
          f"pixels of the frame fill all {K} slots and are excluded), "
          f"beyond 5e-4: {over}")
    assert len(pixels) >= 32 and len(over) <= 1, over


def test_frame_masks_say_what_the_engine_found(case):
    """``frame_colors(masks=True)``: the same colors, and per pixel what the
    primary trace and the shadow queries found."""
    pscene, hit = case["pscene"], case["hit"]
    plain = pwf.frame_colors(pscene, W, H, "cpu")
    colors, masks = pwf.frame_colors(pscene, W, H, "cpu", masks=True)
    assert np.array_equal(colors, plain)
    assert sorted(masks) == ["filtered", "full", "grazing", "hit", "layered",
                             "shadowed"]

    def to_px(v):
        return case["unswz"](_t(np.pad(v.numpy(), (0, pwf.TILE - W * H)))) \
            .numpy()[:W * H].reshape(H, W)

    assert np.array_equal(masks["hit"], to_px(hit["hit"]))
    assert np.array_equal(masks["layered"], to_px(hit["tidT"][0] >= 0))
    assert np.array_equal(masks["full"],
                          to_px((hit["tidT"] >= 0).all(dim=0)))
    body = masks["hit"] | masks["layered"]
    for name in ("shadowed", "filtered"):
        assert masks[name].any() and not (masks[name] & ~body).any()
    # the point light of these scenes stands well off every surface it
    # lights; only the global light can graze one
    assert masks["grazing"].sum() <= MAX_FLIPS


def test_solids_and_high_dimensions_still_raise():
    """Solids (glass ones too, ROADMAP item 8) and transparent scenes of
    d > 8 (item 10) render now, the glass cube showing what lies behind it;
    a format with a 24-bit channel (item 13) packs on the host, exactly."""
    nt = NTracer(3)
    glass = Material((1, 1, 1), opacity=0.5)

    def scene_with(cube):
        protos = [nt.TrianglePrototype([nt.Vector(0, 0, 0),
                                        nt.Vector(1, 0, 0),
                                        nt.Vector(0, 1, 0)], glass),
                  nt.SolidPrototype(CUBE, nt.Vector(0, 0, 2),
                                    nt.Matrix.identity(), cube)]
        scene = nt.build_composite_scene(protos)
        cam = nt.Camera()
        cam.translate(nt.Vector.axis(2, -8))
        scene.set_camera(cam)
        return scene

    fmt = rgb8(32, 32)
    scenes = (scene_with(glass), random_scene(9, n=4, seed=1, material=glass))
    for scene in scenes:
        buf = bytearray(fmt.pitch * 32)
        assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
        assert not scene.locked
    see_through = pwf.frame_colors(scenes[0], 32, 32, "cpu")
    opaque = pwf.frame_colors(scene_with(Material((1, 1, 1))), 32, 32, "cpu")
    assert (np.abs(see_through - opaque).max(axis=2) > 1e-3).sum() > 20
    wide = ImageFormat(32, 32, [Channel(24, 1, 0, 0), Channel(8, 0, 1, 0)])
    buf = bytearray(wide.pitch * 32)
    assert BlockingRenderer(device="cpu").render(buf, wide, scenes[0])
    assert bytes(buf) == pwf.packing.pack_rows(see_through, wide).tobytes()
