"""Lit scenes with shadows: ntracer_tpu_torch vs the JAX package and the
scalar oracle.

Both engines shade the same scene (the JAX package's device scene, as numpy
arrays, becomes the port's tensors) from the same rays.  The JAX side runs
its Pallas walks in interpret mode.

Tolerance.  Colors agree to rtol 2e-6, atol 2e-7 (XLA on the CPU contracts
a*b+c into FMAs, the port rounds every operation) and bytes within one code,
on every ray whose shadow masks agree between the engines: ``want`` (the
light is worth a shadow ray: it faces the surface and is brighter than
LIGHT_THRESHOLD) and ``blocked`` (the walk found an occluder), per light and
per bounce.  Those ulps can flip a mask at a shadow edge or at the
threshold; such rays are counted, printed, and must stay under 0.2% of the
frame.  Every ray out of tolerance must be one of them.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu.engine import packing as jpack
from ntracer_tpu_torch import BlockingRenderer, ImageFormat, Channel, kdnodes
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import (JAX, PORT, lit_scene, lit_scene_3d,
                            reflective_scene, random_scene, glass_scene,
                            rgb8, jax_device_scene)

W = H = 64
MAX_FLIPS = int(0.002 * W * H)          # 0.2% of the frame: 8 pixels

SCENES = {
    "3d_lit": lambda pkg: lit_scene_3d(pkg=pkg),
    "6d_lit_200": lambda pkg: lit_scene(6, n=200, pkg=pkg),
    "3d_reflective_shadows": lambda pkg: reflective_scene(shadows=True,
                                                          pkg=pkg),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _record_jax(monkeypatch, log):
    """Log (want, blocked) of every occlusion query of the JAX engine."""
    inner = jwf.occlusion

    def occlusion(arrs, cfg, o, dirs, ldist, skip, **kw):
        blocked, filt = inner(arrs, cfg, o, dirs, ldist, skip, **kw)
        log.append((np.asarray(ldist) > 0, np.asarray(blocked)))
        return blocked, filt

    monkeypatch.setattr(jwf, "occlusion", occlusion)


def _record_port(monkeypatch, log):
    inner = pwf.occlusion

    def occlusion(arrs, cfg, oT, dT, ldist, skip, **kw):
        blocked, filt = inner(arrs, cfg, oT, dT, ldist, skip, **kw)
        assert filt is None             # no transparent material here
        log.append(((ldist > 0).numpy(), blocked.numpy()))
        return blocked, filt

    monkeypatch.setattr(pwf, "occlusion", occlusion)


def _mask_flips(jlog, plog):
    """Rays on which any shadow mask differs between the engines."""
    assert len(jlog) == len(plog) > 0
    flip = np.zeros_like(jlog[0][0])
    for (jw, jb), (pw, pb) in zip(jlog, plog):
        flip |= (jw != pw) | ((jb & jw) != (pb & pw))
    return flip


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    """Both packages' scenes from one seed, the JAX device scene as the
    port's tensors, and the frame's rays (tile order; the first W*H rays
    are the frame's pixels)."""
    mp = pytest.MonkeyPatch()
    jscene = SCENES[request.param](JAX)
    pscene = SCENES[request.param](PORT)
    if "reflective" in request.param:
        for s in (jscene, pscene):
            s.set_max_reflect_depth(2)
    jcfg, arrs, _ = jax_device_scene(jscene, mp)
    jdev = jwf.get_device_scene(jscene)[1]
    mp.undo()
    pcfg, parrs, _ = pwf.get_device_scene(pscene, "cpu")
    assert pcfg == pwf.SceneConfig(**{k: v for k, v in vars(jcfg).items()
                                      if k != "prim_axis"})
    assert pcfg.shadows and pcfg.n_point_lights and pcfg.n_global_lights
    tens = pwf.tensors_from_arrays(arrs, "cpu")
    # the arrays this slice reads: the same in both packages
    for k in ("pl_pos", "pl_color", "gl_dir", "gl_color", "mat_pack"):
        assert torch.equal(tens[k], parrs[k]), k
    pscene._set_view_size(W, H)
    fov = pwf._fov_params(W, H, pscene.fov)
    groups = pwf._frame_groups(-(-(W * H) // pwf.TILE))
    xs, ys, unswz = pwf._frame_coords(groups, W, "cpu")
    cam_o = np.asarray(pscene._cam._origin, np.float32)
    cam_t = np.asarray(pscene._cam._t, np.float32)
    return dict(name=request.param, jscene=jscene, pscene=pscene, jcfg=jcfg,
                pcfg=pcfg, jdev=jdev, tens=tens, fov=fov, xs=xs, ys=ys,
                unswz=unswz, cam_o=cam_o, cam_t=cam_t,
                jdyn=jwf._scene_dyn(jscene),
                pdyn=pwf._scene_dyn(pscene, "cpu"))


def test_shade_local_T_matches_jax(case, monkeypatch):
    """``shade_local_T`` of both packages on identical numpy inputs: the
    port's primary hits."""
    tens, pcfg = case["tens"], case["pcfg"]
    oT, dT = pwf.make_rays(_t(case["cam_o"]), _t(case["cam_t"]), *case["fov"],
                           case["xs"], case["ys"])
    R = oT.shape[1]
    hit = pwf.trace_pool(tens, pcfg, oT, dT,
                         torch.full((R,), -1, dtype=torch.int32),
                         shared_origin=_t(case["cam_o"]))
    live = hit["hit"]
    jlog, plog = [], []
    _record_jax(monkeypatch, jlog)
    _record_port(monkeypatch, plog)
    got = pwf.shade_local_T(tens, pcfg, dT, hit["pointT"], hit["normalT"],
                            hit["pid"], hit["mat"], 0, case["pdyn"],
                            active=live)
    ref = jwf.shade_local_T(
        case["jdev"], case["jcfg"], jnp.asarray(dT.numpy()),
        jnp.asarray(hit["pointT"].numpy()),
        jnp.asarray(hit["normalT"].numpy()), jnp.asarray(hit["pid"].numpy()),
        jnp.asarray(hit["mat"].numpy()), 0, case["jdyn"],
        active=jnp.asarray(live.numpy()))
    n_lights = pcfg.n_point_lights + pcfg.n_global_lights
    assert len(plog) == len(jlog) == n_lights
    flips = _mask_flips(jlog, plog)
    print(f"{case['name']}: {int(live.sum())} hits, "
          f"{int(flips.sum())} rays with a differing shadow mask")
    assert flips.sum() <= MAX_FLIPS
    ok = live.numpy() & ~flips
    assert ok.sum() > 50
    assert any(b[w].any() for w, b in plog), "no ray is in shadow"
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy()[:, ok], np.asarray(r)[:, ok],
                                   rtol=2e-6, atol=2e-7)


def _jax_frame_colors(case):
    """The JAX package's single-device frame path (one slab at this size)
    with raw float colors, in ray order (3, R)."""
    fa = jwf._frame_args(case["jscene"], W, H)
    n_tiles = -(-(W * H) // jwf.TILE)
    assert n_tiles == 1
    out = np.asarray(jwf._frame_packed_composite(
        case["jdev"], case["jcfg"], fa["dyn"], fa["cam"][0], fa["cam"][1],
        fa["fov"], jwf._frame_base(fa, 0), W, n_tiles, None))
    return out[:W * H].reshape(H, W, 3)


def test_lit_frame_matches_jax_and_oracle(case, monkeypatch):
    jlog, plog = [], []
    _record_jax(monkeypatch, jlog)
    _record_port(monkeypatch, plog)
    tens, pcfg = case["tens"], case["pcfg"]

    # the bounce loop of both packages, run eagerly on the same rays, with
    # every occlusion query's masks logged
    oT, dT = pwf.make_rays(_t(case["cam_o"]), _t(case["cam_t"]), *case["fov"],
                           case["xs"], case["ys"])
    got = pwf._ray_colors_T(tens, pcfg, case["pdyn"], oT, dT).numpy()
    o = jnp.asarray(oT.numpy().T)
    dirs = jnp.asarray(dT.numpy().T)
    pctx = jwf.primary_ctx(case["jdev"], case["jcfg"],
                           jnp.asarray(case["cam_o"]))
    ref = np.asarray(jwf._ray_colors_T(case["jdev"], case["jcfg"],
                                       case["jdyn"], o, dirs, False, pctx,
                                       want_T=True))
    bounces = pcfg.max_reflect_depth if pcfg.has_reflectivity else 0
    n_lights = pcfg.n_point_lights + pcfg.n_global_lights
    assert len(plog) == len(jlog) == n_lights * (bounces + 1)
    flips = _mask_flips(jlog, plog)
    px = slice(0, W * H)                # the frame's own rays
    n_flips = int(flips[px].sum())
    print(f"{case['name']}: {n_flips} of {W * H} pixels with a differing "
          f"shadow mask: rays {np.nonzero(flips[px])[0].tolist()}")
    assert n_flips <= MAX_FLIPS
    assert np.isfinite(got).all()
    shadowed = sum(int((b & w)[px].sum()) for w, b in plog)
    wanted = sum(int(w[px].sum()) for w, b in plog)
    assert 0 < shadowed < wanted
    np.testing.assert_allclose(got[:, ~flips], ref[:, ~flips], rtol=2e-6,
                               atol=2e-7)
    # a flipped ray differs by a light's whole contribution, or not at all
    # (the light may be dark there); nothing else is out of tolerance
    monkeypatch.undo()

    # the whole frame through each package's frame path
    pframe = pwf.frame_colors(case["pscene"], W, H, "cpu")
    assert pframe.shape == (H, W, 3)
    frame_flips = case["unswz"](_t(flips)).numpy()[:W * H].reshape(H, W)
    np.testing.assert_array_equal(
        pframe.reshape(-1, 3), case["unswz"](_t(got.T)).numpy()[:W * H])
    jframe = _jax_frame_colors(case)
    close = np.isclose(pframe, jframe, rtol=2e-6, atol=2e-7).all(axis=2)
    print(f"{case['name']}: {int((~close).sum())} pixels beyond tolerance "
          f"against the jitted JAX frame, {int((~close & ~frame_flips).sum())}"
          f" of them outside the logged flips")
    assert (~close).sum() <= MAX_FLIPS

    # packed bytes through the port's renderer: within one code of JAX's
    fmt = rgb8(W, H)
    buf = bytearray(fmt.pitch * H)
    assert BlockingRenderer(device="cpu").render(buf, fmt, case["pscene"])
    ref_bytes = np.asarray(jpack.pack_device(
        jnp.asarray(jframe.reshape(-1, 3)), jpack.format_key(fmt)))
    diff = np.abs(np.frombuffer(bytes(buf), np.uint8).astype(int)
                  - ref_bytes.reshape(-1).astype(int)).reshape(H, W, 3)
    assert diff[close].max() <= 1

    # the port's scalar oracle at seeded pixels, with exact occlusion (the
    # reference's early-out misses occluders of global lights; the engine
    # is any-hit)
    monkeypatch.setattr(kdnodes, "OCCLUDES_EARLY_OUT", False)
    pscene = case["pscene"]
    pscene._set_view_size(W, H)
    rng = np.random.RandomState(1)
    over = []
    for _ in range(48):
        x, y = int(rng.randint(W)), int(rng.randint(H))
        diff = float(np.abs(pscene._pixel_color(x, y) - pframe[y, x]).max())
        if diff >= 5e-5:
            over.append((x, y, diff))
    print(f"{case['name']}: oracle pixels beyond 5e-5: {over}")
    assert len(over) <= 1, over


def test_lit_scenes_render_and_unsupported_ones_name_their_item():
    """A lit scene, a reflective lit scene and a lit scene of glass render;
    the transparent occlusion query refuses a pool without an opacity row
    instead of treating it as opaque, and a format the port does not pack
    still names its ROADMAP item."""
    fmt = rgb8(32, 32)
    for scene in (lit_scene_3d(), reflective_scene(shadows=True),
                  glass_scene(200, lit=True)):
        buf = bytearray(fmt.pitch * 32)
        assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
        assert any(buf) and not scene.locked
    a = random_scene(3, n=20, seed=1)
    cfg, arrs, _ = pwf.get_device_scene(a, "cpu")
    import dataclasses
    tcfg = dataclasses.replace(cfg, has_transparency=True)
    z = torch.zeros((3, 512))
    with pytest.raises(ValueError, match="opacity row"):
        pwf.occlusion(arrs, tcfg, z, z, torch.zeros(512),
                      torch.zeros(512, dtype=torch.int32))
    wide = ImageFormat(32, 32, [Channel(24, 1, 0, 0), Channel(8, 0, 1, 0)])
    with pytest.raises(NotImplementedError, match=r"item 13\)"):
        BlockingRenderer(device="cpu").render(bytearray(wide.pitch * 32),
                                              wide, lit_scene_3d())


def test_shadows_change_the_frame():
    """Shadows on and off give different frames (shadowed pixels lose a
    light; lit ones gain its highlight, which only the shadow path adds)."""
    scene = lit_scene_3d()
    lit = pwf.frame_colors(scene, W, H, "cpu")
    scene.set_shadows(False)
    unshadowed = pwf.frame_colors(scene, W, H, "cpu")
    assert (lit < unshadowed - 1e-3).any(axis=2).sum() > 20
