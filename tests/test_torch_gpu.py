"""ntracer_tpu_torch on a CUDA card: each kernel against its twin, and the
card's frames against the CPU's.  Every test here is marked ``gpu`` and skips
without a card.  The file imports no jax, so it also runs where only torch
is installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from ntracer_tpu_torch import BlockingRenderer
from ntracer_tpu_torch.engine import wavefront as pwf
from ntracer_tpu_torch.engine import grid_kernels as gk
from ntracer_tpu_torch.engine import resident_kernels as prk

from _torch_helpers import (random_scene, polytope_scene, reflective_scene,
                            lit_scene, lit_scene_3d, glass_scene, rgb8,
                            mirror_scene_1500, api, orthoplex_scene, _smoke)

pytestmark = pytest.mark.gpu
W = H = 64
N = pwf.TILE


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _primary(scene, dev):
    cfg, arrs, _ = pwf.get_device_scene(scene, dev)
    scene._set_view_size(W, H)
    fov = pwf._fov_params(W, H, scene.fov)
    xs, ys, _ = pwf._ray_coords(0, W, N, dev)
    cam_o = torch.as_tensor(np.asarray(scene._cam._origin, np.float32),
                            device=dev)
    cam_t = torch.as_tensor(np.asarray(scene._cam._t, np.float32),
                            device=dev)
    oT, dT = pwf.make_rays(cam_o, cam_t, *fov, xs, ys)
    return cfg, arrs, cam_o, oT, dT


@pytest.mark.parametrize("make", [polytope_scene,
                                  lambda: random_scene(3, n=1200, seed=7)])
def test_kernel_matches_twin(cuda, make):
    """Bit for bit in both walk modes: primary (shared rows, front-to-back
    order) and bounce (pool order, every other block inactive, skip ids)."""
    scene = make()
    cfg, arrs, cam_o, oT, dT = _primary(scene, cuda)
    pctx = pwf.primary_ctx(arrs, cfg, cam_o)
    res = pwf._res_dict(arrs)
    skip = torch.full((N,), -1, dtype=torch.int32, device=cuda)
    hit = pwf.trace_pool(arrs, cfg, oT, dT, skip, shared_origin=cam_o,
                         pctx=pctx)
    sine = -pwf._dotT(dT, hit["normalT"])
    b_dT = pwf._unitT(dT - hit["normalT"] * (-2 * sine)[None, :])
    blk = torch.arange(N, device=cuda) // prk.RAY_BLOCK
    for args, kw in (
            ((oT, dT, skip), dict(order=pctx["order"], sh=pctx["sh_res"])),
            ((hit["pointT"], b_dT, hit["pid"]),
             dict(active=hit["hit"] & (blk % 2 == 0)))):
        before = prk.nearest_hit.launches
        kt, ks, kv = prk.nearest_hit(res, *args, cfg.d, **kw)
        assert prk.nearest_hit.launches == before + 1
        pt, ps, pv = prk.nearest_hit_ref(res, *args, cfg.d, **kw)
        assert torch.equal(ks, ps) and torch.equal(kv, pv)
        assert torch.equal(kt.view(torch.int32), pt.view(torch.int32))
    assert int(hit["hit"].sum()) > 100


def test_card_frame_matches_cpu_frame(cuda):
    """The card renders what the CPU renders: the same winners, colors
    within the libm ulps of pow, bytes within one code."""
    scene = reflective_scene()
    cfg_c, arrs_c, cam_c, oT_c, dT_c = _primary(scene, cuda)
    cfg, arrs, cam, oT, dT = _primary(scene, "cpu")
    skip = torch.full((N,), -1, dtype=torch.int32)
    assert torch.equal(dT_c.cpu(), dT)
    res_c = pwf.trace_pool(arrs_c, cfg_c, oT_c, dT_c, skip.to(cuda),
                           shared_origin=cam_c)
    res = pwf.trace_pool(arrs, cfg, oT, dT, skip, shared_origin=cam)
    assert torch.equal(res_c["pid"].cpu(), res["pid"])
    assert torch.equal(res_c["t"].cpu(), res["t"])
    got = pwf.frame_colors(scene, W, H, cuda)
    ref = pwf.frame_colors(scene, W, H, "cpu")
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)
    fmt = rgb8(W, H)
    a = bytearray(fmt.pitch * H)
    b = bytearray(fmt.pitch * H)
    assert BlockingRenderer().render(a, fmt, scene)
    assert BlockingRenderer(device="cpu").render(b, fmt, scene)
    diff = np.abs(np.frombuffer(bytes(a), np.uint8).astype(int)
                  - np.frombuffer(bytes(b), np.uint8).astype(int))
    assert diff.max() <= 1


@pytest.mark.parametrize("make", [lit_scene_3d,
                                  lambda: lit_scene(6, n=200, off_view=0.05)])
def test_occluded_kernel_matches_twin(cuda, make):
    """``blocked`` and ``visits`` equal on every ray and block: shadow rays
    from the primary hits towards a point light (finite distances) and
    along a global light (distance cut to the pool's box), every other
    block dead, misses inactive, each ray skipping the surface it leaves."""
    scene = make()
    cfg, arrs, cam_o, oT, dT = _primary(scene, cuda)
    res = pwf._res_dict(arrs)
    skip = torch.full((N,), -1, dtype=torch.int32, device=cuda)
    hit = pwf.trace_pool(arrs, cfg, oT, dT, skip, shared_origin=cam_o)
    blk = torch.arange(N, device=cuda) // prk.RAY_BLOCK
    live = hit["hit"] & (blk % 2 == 0)
    assert int(live.sum()) > 20
    point = torch.where(hit["hit"][None, :], hit["pointT"], 0.0)
    lv = point - arrs["pl_pos"][0][:, None]
    dist = prk._sqrt(pwf._dotT(lv, lv))
    gl = (-arrs["gl_dir"][0])[:, None].expand_as(point).contiguous()
    exit_t = prk._scene_exit_T(point, gl, res["b_lo"], res["b_hi"])
    for dirs, ldist in (
            ((lv / dist[None, :]).contiguous(), torch.where(live, dist, 0.0)),
            (gl, torch.where(live, exit_t, 0.0))):
        before = prk.occluded.launches
        kb, kv = prk.occluded(res, point, dirs, ldist, hit["pid"], cfg.d)
        assert prk.occluded.launches == before + 1
        torch.cuda.synchronize()
        pb, pv = prk.occluded_ref(res, point, dirs, ldist, hit["pid"], cfg.d)
        assert kb.dtype == torch.bool and torch.equal(kb, pb)
        assert torch.equal(kv, pv)
        assert not kb[~live].any() and (kv[1::2] == 0).all() and kv.any()
    # a wholly dead wavefront: one launch, nothing blocked, no visit
    kb, kv = prk.occluded(res, point, gl, torch.zeros_like(dist), hit["pid"],
                          cfg.d)
    assert not kb.any() and not kv.any()


@pytest.mark.parametrize("make", [lit_scene_3d,
                                  lambda: reflective_scene(shadows=True)])
def test_card_lit_frame_matches_cpu_frame(cuda, make):
    """A lit frame with shadows (and one with reflections under shadows)
    on the card equals the CPU's: colors within the libm ulps of pow,
    bytes within one code; both kernels ran."""
    scene = make()
    n0, o0 = prk.nearest_hit.launches, prk.occluded.launches
    got = pwf.frame_colors(scene, W, H, cuda)
    assert prk.nearest_hit.launches > n0
    assert prk.occluded.launches >= o0 + 2      # a point and a global light
    ref = pwf.frame_colors(scene, W, H, "cpu")
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)
    fmt = rgb8(W, H)
    a = bytearray(fmt.pitch * H)
    b = bytearray(fmt.pitch * H)
    assert BlockingRenderer().render(a, fmt, scene)
    assert BlockingRenderer(device="cpu").render(b, fmt, scene)
    diff = np.abs(np.frombuffer(bytes(a), np.uint8).astype(int)
                  - np.frombuffer(bytes(b), np.uint8).astype(int))
    assert diff.max() <= 1


GLASS = {
    "3d_mixed": lambda: glass_scene(600, lit=True),
    "3d_all_glass": lambda: glass_scene(500, seed=3, spread=0.7,
                                        all_glass=True, lit=True),
    "4d_600cell": lambda: polytope_scene(glass=True, lit=True),
}


@pytest.mark.parametrize("name", sorted(GLASS))
@pytest.mark.parametrize("K", [8, 2])
def test_transparent_kernels_match_twins(cuda, name, K):
    """Kernel 2.3 = its twin on t, slot, every one of the K slots position by
    position and visits, in primary and bounce mode; kernel 2.4 = its twin on
    ``blocked``, ``filt`` (bit for bit, 1 where blocked) and visits, from the
    first surface along each ray towards a point light and along a global
    light, every other block dead; dead wavefronts cost no visit."""
    scene = GLASS[name]()
    cfg, arrs, cam_o, oT, dT = _primary(scene, cuda)
    assert cfg.has_transparency
    pctx = pwf.primary_ctx(arrs, cfg, cam_o)
    res = pwf._res_dict(arrs)
    skip = torch.full((N,), -1, dtype=torch.int32, device=cuda)
    blk = torch.arange(N, device=cuda) // prk.RAY_BLOCK
    kw = dict(order=pctx["order"], sh=pctx["sh_res"])
    _t, slot, tt, ts, _v = prk.nearest_hit_transparent_ref(
        res, oT, dT, skip, cfg.d, 8, **kw)
    # the first surface along each ray, glass or opaque
    all_t = torch.cat([torch.where(slot >= 0, _t, float("inf"))[None], tt])
    k = all_t.argmin(dim=0, keepdim=True)
    first = torch.gather(all_t, 0, k)[0]
    fslot = torch.gather(torch.cat([slot[None], ts]), 0, k)[0]
    found = torch.isfinite(first)
    pid = torch.where(found, res["ids"][:, 0].reshape(-1)[
        fslot.clamp(min=0).long()], -1).to(torch.int32)
    point = torch.where(found[None, :], oT + torch.where(
        found, first, 0.0)[None, :] * dT, 0.0)
    rng = np.random.RandomState(5)
    b_dT = torch.as_tensor(rng.normal(size=dT.shape).astype(np.float32),
                           device=cuda)
    b_dT = pwf._unitT(b_dT)
    for args, akw in (((oT, dT, skip), kw),
                      ((point, b_dT, pid),
                       dict(active=found & (blk % 2 == 0)))):
        before = prk.nearest_hit_transparent.launches
        got = prk.nearest_hit_transparent(res, *args, cfg.d, K, **akw)
        assert prk.nearest_hit_transparent.launches == before + 1
        torch.cuda.synchronize()
        ref = prk.nearest_hit_transparent_ref(res, *args, cfg.d, K, **akw)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        assert int((got[3] >= 0).sum()) > 20
    live = found & (blk % 2 == 0)
    lv = point - arrs["pl_pos"][0][:, None]
    dist = prk._sqrt(pwf._dotT(lv, lv))
    gl = (-arrs["gl_dir"][0])[:, None].expand_as(point).contiguous()
    exit_t = prk._scene_exit_T(point, gl, res["b_lo"], res["b_hi"])
    filtered = 0
    for dirs, ldist in (
            ((lv / dist[None, :]).contiguous(), torch.where(live, dist, 0.0)),
            (gl, torch.where(live, exit_t, 0.0))):
        before = prk.occluded_transparent.launches
        kb, kf, kv = prk.occluded_transparent(res, point, dirs, ldist, pid,
                                              cfg.d)
        assert prk.occluded_transparent.launches == before + 1
        torch.cuda.synchronize()
        pb, pf, pv = prk.occluded_transparent_ref(res, point, dirs, ldist,
                                                  pid, cfg.d)
        assert kb.dtype == torch.bool and torch.equal(kb, pb)
        assert torch.equal(kf.view(torch.int32), pf.view(torch.int32))
        assert torch.equal(kv, pv)
        assert not kb[~live].any() and (kf[~live] == 1).all()
        assert (kf[kb] == 1).all() and (kv[1::2] == 0).all() and kv.any()
        filtered += int(((kf < 1) & ~kb).sum())
    assert filtered > 20
    dead = torch.zeros(N, dtype=torch.bool, device=cuda)
    t, slot, tt, ts, vis = prk.nearest_hit_transparent(
        res, oT, dT, skip, cfg.d, K, active=dead)
    assert not t.any() and (slot == -1).all() and (ts == -1).all()
    assert torch.isinf(tt).all() and not vis.any()
    kb, kf, kv = prk.occluded_transparent(res, point, gl,
                                          torch.zeros_like(dist), pid, cfg.d)
    assert not kb.any() and (kf == 1).all() and not kv.any()


@pytest.mark.parametrize("make", [
    lambda: glass_scene(300, lit=True),
    lambda: glass_scene(200, seed=21, spread=0.8, lit=True,
                        reflectivity=0.4),
    lambda: polytope_scene(glass=True, lit=True)])
def test_card_glass_frame_matches_cpu_frame(cuda, make):
    """A frame of glass under two lights with shadows (and one with mirrors
    behind the glass) on the card equals the CPU's: colors within the libm
    ulps of pow, bytes within one code; both transparent kernels ran, the
    filtered walk once per light for the opaque hit and each of the K
    slots."""
    scene = make()
    scene.set_max_reflect_depth(1)
    cfg, _arrs, _ = pwf.get_device_scene(scene, cuda)
    n0 = prk.nearest_hit_transparent.launches
    o0 = prk.occluded_transparent.launches
    got = pwf.frame_colors(scene, W, H, cuda)
    bounces = 1 + (cfg.max_reflect_depth if cfg.has_reflectivity else 0)
    assert prk.nearest_hit_transparent.launches == n0 + bounces
    assert prk.occluded_transparent.launches == \
        o0 + 2 * (cfg.max_transparent_hits + 1) * bounces
    ref = pwf.frame_colors(scene, W, H, "cpu")
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)
    fmt = rgb8(W, H)
    a = bytearray(fmt.pitch * H)
    b = bytearray(fmt.pitch * H)
    assert BlockingRenderer().render(a, fmt, scene)
    assert BlockingRenderer(device="cpu").render(b, fmt, scene)
    diff = np.abs(np.frombuffer(bytes(a), np.uint8).astype(int)
                  - np.frombuffer(bytes(b), np.uint8).astype(int))
    assert diff.max() <= 1


def _glass_high_d(d=7, n=600, seed=3):
    """``n`` random d-D simplices centred in the viewed 3-space (as
    ``lit_scene(off_view=0)`` places them), glass and opaque by turns, under a
    point and a global light: the streaming walks' shorter ring (six or
    seven slots at d = 7 and 8)."""
    a = api()
    nt = a.NTracer(d)
    solid = a.Material((0.3, 0.8, 0.5))
    glass = a.Material((1, 0.7, 0.7), opacity=0.4)
    rng = np.random.RandomState(seed)
    protos = []
    for i in range(n):
        base = rng.uniform(-2, 2, d)
        base[3:] = 0
        pts = [nt.Vector(*(base + rng.uniform(-0.7, 0.7, d)))
               for _ in range(d)]
        protos.append(nt.TrianglePrototype(pts, glass if i % 2 else solid))
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, -8))
    scene.set_camera(cam)
    scene.add_light(nt.PointLight(nt.Vector.axis(1, 5), (1, 0.9, 0.7)))
    scene.add_light(nt.GlobalLight(nt.Vector.axis(1, -1), (0.2, 0.2, 0.3)))
    scene.set_shadows(True)
    return scene


def _narrow_glass():
    """Glass and opaque by turns seen through a 0.1 rad field of view: the
    grouped schedule of kernel 2.7 moves slots against kernel 2.3's."""
    scene = glass_scene(3000, seed=31, spread=0.4, lit=True)
    scene.set_fov(0.1)
    return scene


OVER_THE_LINE = {
    "3d_mirror_1500": mirror_scene_1500,
    "4d_600cell": lambda: polytope_scene(lit=True),
    "8d_lit": lambda: lit_scene(8, n=600, off_view=0.0),
    "3d_mixed": lambda: glass_scene(600, lit=True),
    "3d_all_glass": lambda: glass_scene(500, seed=3, spread=0.7,
                                        all_glass=True, lit=True),
    "3d_narrow_glass": _narrow_glass,
    "7d_glass": _glass_high_d,
}


def _equal(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        if g.dtype == torch.float32:
            assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        else:
            assert torch.equal(g, r)


@pytest.mark.parametrize("name", sorted(OVER_THE_LINE))
def test_streaming_kernels_match_twins(cuda, name, monkeypatch):
    """Kernels 2.5-2.8 on pools over the line (the line monkeypatched to
    1 KiB): each equals its twin bit for bit, in primary and bounce mode
    and for shadow rays towards a point light and along a global light;
    2.5 = 2.1, 2.6 = 2.2 and 2.8 = 2.4 on the same inputs, and 2.7 has
    2.3's t and opaque slot."""
    monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    scene = OVER_THE_LINE[name]()
    cfg, arrs, cam_o, oT, dT = _primary(scene, cuda)
    assert "res_is_hbm" in arrs
    pctx = pwf.primary_ctx(arrs, cfg, cam_o)
    res = pwf._res_dict(arrs)
    d = cfg.d
    skip = torch.full((N,), -1, dtype=torch.int32, device=cuda)
    blk = torch.arange(N, device=cuda) // prk.RAY_BLOCK
    kw = dict(order=pctx["order"], sh=pctx["sh_res"])
    # the first surface along each primary ray, glass or opaque
    if cfg.has_transparency:
        t, slot, tt, ts, _v = prk.nearest_hit_transparent_hbm_ref(
            res, oT, dT, skip, d, 8, **kw)
        all_t = torch.cat([torch.where(slot >= 0, t, float("inf"))[None],
                           tt])
        k = all_t.argmin(dim=0, keepdim=True)
        first = torch.gather(all_t, 0, k)[0]
        fslot = torch.gather(torch.cat([slot[None], ts]), 0, k)[0]
    else:
        t, fslot, _v = prk.nearest_hit_hbm_ref(res, oT, dT, skip, d, **kw)
        first = torch.where(fslot >= 0, t, float("inf"))
    found = torch.isfinite(first)
    print(f"{name}: {int(found.sum())} of {N} primary rays hit")
    assert int(found.sum()) > 20
    pid = torch.where(found, res["ids"][:, 0].reshape(-1)[
        fslot.clamp(min=0).long()], -1).to(torch.int32)
    point = torch.where(found[None, :], oT + torch.where(
        found, first, 0.0)[None, :] * dT, 0.0)
    live = found & (blk % 2 == 0)
    rng = np.random.RandomState(5)
    b_dT = pwf._unitT(torch.as_tensor(
        rng.normal(size=dT.shape).astype(np.float32), device=cuda))
    for args, akw in (((oT, dT, skip), kw),
                      ((point, b_dT, pid), dict(active=live))):
        if cfg.has_transparency:
            before = prk.nearest_hit_transparent_hbm.launches
            got = prk.nearest_hit_transparent_hbm(res, *args, d, 8, **akw)
            assert prk.nearest_hit_transparent_hbm.launches == before + 1
            torch.cuda.synchronize()
            _equal(got, prk.nearest_hit_transparent_hbm_ref(res, *args, d, 8,
                                                            **akw))
            one = prk.nearest_hit_transparent(res, *args, d, 8, **akw)
            _equal(got[:2], one[:2])
            print(f"{name}: {int((got[3] != one[3]).any(dim=0).sum())} rays' "
                  f"slots differ between the schedules")
        else:
            before = prk.nearest_hit_hbm.launches
            got = prk.nearest_hit_hbm(res, *args, d, **akw)
            assert prk.nearest_hit_hbm.launches == before + 1
            torch.cuda.synchronize()
            _equal(got, prk.nearest_hit_hbm_ref(res, *args, d, **akw))
            _equal(got, prk.nearest_hit(res, *args, d, **akw))
    lv = point - arrs["pl_pos"][0][:, None]
    dist = prk._sqrt(pwf._dotT(lv, lv))
    gl = (-arrs["gl_dir"][0])[:, None].expand_as(point).contiguous() \
        if cfg.n_global_lights else (lv / dist[None, :]).contiguous()
    exit_t = prk._scene_exit_T(point, gl, res["b_lo"], res["b_hi"])
    for dirs, ldist in (
            ((lv / dist[None, :]).contiguous(), torch.where(live, dist, 0.0)),
            (gl, torch.where(live, exit_t, 0.0))):
        args = (res, point, dirs, ldist, pid, d)
        if cfg.has_transparency:
            before = prk.occluded_transparent_hbm.launches
            got = prk.occluded_transparent_hbm(*args)
            assert prk.occluded_transparent_hbm.launches == before + 1
            torch.cuda.synchronize()
            _equal(got, prk.occluded_transparent_hbm_ref(*args))
            _equal(got, prk.occluded_transparent(*args))
        else:
            before = prk.occluded_hbm.launches
            got = prk.occluded_hbm(*args)
            assert prk.occluded_hbm.launches == before + 1
            torch.cuda.synchronize()
            _equal(got, prk.occluded_hbm_ref(*args))
            _equal(got, prk.occluded(*args))
        assert not got[0][~live].any() and got[-1].any()


STREAMING = ("nearest_hit_hbm", "occluded_hbm", "nearest_hit_transparent_hbm",
             "occluded_transparent_hbm")
RESIDENT = ("nearest_hit", "occluded", "nearest_hit_transparent",
            "occluded_transparent")


@pytest.mark.parametrize("make", [mirror_scene_1500,
                                  lambda: glass_scene(300, lit=True)])
def test_card_frame_over_the_line_takes_the_streaming_kernels(cuda, make,
                                                              monkeypatch):
    """A scene over the line renders on the card through the streaming
    kernels only, and as the CPU renders it."""
    monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    scene = make()
    cfg, arrs, _ = pwf.get_device_scene(scene, cuda)
    assert "res_is_hbm" in arrs
    before = {n: getattr(prk, n).launches for n in STREAMING + RESIDENT}
    got = pwf.frame_colors(scene, W, H, cuda)
    moved = {n: getattr(prk, n).launches - before[n]
             for n in STREAMING + RESIDENT}
    assert not any(moved[n] for n in RESIDENT), moved
    walks = ("nearest_hit_transparent_hbm", "occluded_transparent_hbm") \
        if cfg.has_transparency else ("nearest_hit_hbm", "occluded_hbm")
    assert all(moved[n] > 0 for n in walks), moved
    ref = pwf.frame_colors(scene, W, H, "cpu")
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)


def _random16():
    """A 16-D pool of 200 random simplices (chip_smoke.random_pool), with
    the simplices for rays aimed at them."""
    a = api()
    return _smoke().random_pool(a.NTracer(16), a.Material((0.8, 0.5, 0.9)),
                                200)


GRID = {
    "orthoplex9": lambda: (orthoplex_scene(9), None),
    "orthoplex10_shade": lambda: (orthoplex_scene(10, companion="shade"),
                                  None),
    "random16": _random16,
}


def _grid_equal(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        if g.dtype == torch.float32:
            assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        else:
            assert torch.equal(g, r)


@pytest.mark.parametrize("name", sorted(GRID))
def test_grid_kernels_match_twins(cuda, name):
    """Kernels 2.9 and 2.10 (d > 8; here d = 9, 10 and 16) equal their twins
    bit for bit, tiles run included: primary rays with the shared rows (for
    the 16-D pool aimed at its simplices from the camera), the bounce
    wavefront of the reflections off the primary hits (every ray, the
    misses' infinite origins too, each skipping the surface it leaves), and
    shadow rays from the primary hits towards the point light, along the
    global light (REAL_MAX), from a light at the camera (the engine casts
    a shadow ray from the point away from the light: these cross the body)
    and with every ray inactive."""
    scene, simplices = GRID[name]()
    cfg, arrs, cam_o, oT, dT = _primary(scene, cuda)
    assert "kern_gt" in arrs and cfg.d > 8
    if simplices is not None:
        dT = torch.as_tensor(_smoke().aimed(cam_o.cpu().numpy(), simplices,
                                            N), device=cuda)
    kern = pwf._kern_dict(arrs)
    pctx = pwf.primary_ctx(arrs, cfg, cam_o)
    skip = torch.full((N,), -1, dtype=torch.int32, device=cuda)
    n0 = gk.nearest_hit.launches
    hit = pwf.trace_pool(arrs, cfg, oT, dT, skip, shared_origin=cam_o,
                         pctx=pctx)
    assert gk.nearest_hit.launches == n0 + 1
    assert int(hit["hit"].sum()) > 200
    sine = -pwf._dotT(dT, hit["normalT"])
    b_dT = pwf._unitT(dT - hit["normalT"] * (-2 * sine)[None, :])
    for args, kw in (((oT, dT, skip), dict(sh=pctx["sh_kern"])),
                     ((hit["pointT"], b_dT, hit["pid"]), {})):
        got = gk.nearest_hit(kern, *args, cfg.d, **kw)
        torch.cuda.synchronize()
        _grid_equal(got, gk.nearest_hit_ref(kern, *args, cfg.d, **kw))
    point = torch.where(hit["hit"][None, :], hit["pointT"], 0.0)
    blocked_any = 0
    for light in (arrs["pl_pos"][0], None, cam_o, "dead"):
        if light is None:
            dirs = (-arrs["gl_dir"][0])[:, None].expand_as(point).contiguous()
            ldist = torch.where(hit["hit"], pwf.REAL_MAX, 0.0)
        else:
            pos = cam_o if isinstance(light, str) else light
            lv = point - pos[:, None]
            dist = prk._sqrt(pwf._dotT(lv, lv))
            dirs = (lv / dist[None, :]).contiguous()
            ldist = torch.where(hit["hit"], dist, 0.0)
            if isinstance(light, str):
                ldist = torch.zeros_like(ldist)
        o0 = gk.occluded.launches
        got = gk.occluded(kern, point, dirs, ldist, hit["pid"], cfg.d)
        assert gk.occluded.launches == o0 + 1
        torch.cuda.synchronize()
        _grid_equal(got, gk.occluded_ref(kern, point, dirs, ldist,
                                         hit["pid"], cfg.d))
        assert not got[0][ldist <= 0].any()
        blocked_any += int(got[0].sum())
    if simplices is None:           # the orthoplex: rays cross the body
        assert blocked_any > 100


def test_card_grid_frame_matches_cpu_frame(cuda):
    """A 10-D mirror frame (the orthoplex over a mirror floor, reflection
    depth 2, shadows on) on the card equals the CPU's, and went through the
    grid kernels only: one nearest-hit walk a trace, one occlusion walk a
    light and a trace."""
    scene = orthoplex_scene(10, reflectivity=0.5, companion="floor")
    names = ("nearest_hit", "occluded", "nearest_hit_hbm", "occluded_hbm")
    before = {n: getattr(prk, n).launches for n in names}
    g0, o0 = gk.nearest_hit.launches, gk.occluded.launches
    got = pwf.frame_colors(scene, W, H, cuda)
    assert (gk.nearest_hit.launches - g0, gk.occluded.launches - o0) \
        == (3, 6)
    assert all(getattr(prk, n).launches == before[n] for n in names)
    ref = pwf.frame_colors(scene, W, H, "cpu")
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)
    fmt = rgb8(W, H)
    a = bytearray(fmt.pitch * H)
    b = bytearray(fmt.pitch * H)
    assert BlockingRenderer().render(a, fmt, scene)
    assert BlockingRenderer(device="cpu").render(b, fmt, scene)
    diff = np.abs(np.frombuffer(bytes(a), np.uint8).astype(int)
                  - np.frombuffer(bytes(b), np.uint8).astype(int))
    assert diff.max() <= 1
