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
                            mirror_scene_1500, api, orthoplex_scene, _smoke,
                            two_lights, solids_d4_scene,
                            glass_solids_d3_scene, solid_orthoplex_scene)

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


def _frame_bytes(scene, device):
    fmt = rgb8(W, H)
    buf = bytearray(fmt.pitch * H)
    renderer = BlockingRenderer() if device is None \
        else BlockingRenderer(device=device)
    assert renderer.render(buf, fmt, scene)
    return np.frombuffer(bytes(buf), np.uint8).astype(int)


@pytest.mark.parametrize("make", [solids_d4_scene, glass_solids_d3_scene])
def test_card_solid_frame_equals_cpu_frame(cuda, make):
    """A frame with solids among triangles (opaque ones shadowing each
    other; a glass cube in the K slots) on the card gives the CPU's bytes:
    the walks equal their twins and ``_solid_test`` sums in a fixed order.
    The frame went through the chunk walks of its scene."""
    scene = make()
    cfg, _arrs, _ = pwf.get_device_scene(scene, cuda)
    assert cfg.n_solids == 2
    walks = ("nearest_hit_transparent", "occluded_transparent") \
        if cfg.has_transparency else ("nearest_hit", "occluded")
    before = [getattr(prk, n).launches for n in walks]
    got = pwf.frame_colors(scene, W, H, cuda)
    assert all(getattr(prk, n).launches > b for n, b in zip(walks, before))
    ref = pwf.frame_colors(scene, W, H, "cpu")
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)
    assert np.array_equal(_frame_bytes(scene, None),
                          _frame_bytes(scene, "cpu"))


def test_card_scan_frame_matches_cpu_frame(cuda):
    """The glass 10-orthoplex with a glass sphere (the chunk scan, plain
    torch on the card: its matrix products sum in cuBLAS's order) within one
    code of the CPU's frame, and no walk kernel ran."""
    scene = solid_orthoplex_scene(10, glass=True)
    cfg, arrs, _ = pwf.get_device_scene(scene, cuda)
    assert pwf._scan(arrs)
    names = ("nearest_hit", "occluded", "nearest_hit_transparent",
             "occluded_transparent")
    before = [getattr(prk, n).launches for n in names] \
        + [gk.nearest_hit.launches, gk.occluded.launches]
    got = pwf.frame_colors(scene, W, H, cuda)
    assert before == [getattr(prk, n).launches for n in names] \
        + [gk.nearest_hit.launches, gk.occluded.launches]
    ref = pwf.frame_colors(scene, W, H, "cpu")
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4
    diff = np.abs(_frame_bytes(scene, None) - _frame_bytes(scene, "cpu"))
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


def _stack_scene(d, n=300, layers=256, seed=13, ties=0):
    """``n`` random d-D simplices placed as ``_glass_high_d`` places them,
    glass and opaque by turns, and beside them a stack of ``layers`` glass
    simplices across axis 2 (each in the plane x_2 = z, spanning
    ``STACK_SIDE`` along the other axes from ``STACK_BASE``), of opacities
    0.01-0.1.  The layers are wide for the scene, so
    ``centroid_bins`` packs them 128 a chunk, and a ray along axis 2
    through the stack crosses every layer: such a chunk's visit has 128
    factors below 1.  With ``ties`` > 0, two stacks of ``ties`` identical
    simplices in the camera's view, before the rest (``TIE_GLASS`` of
    glass, opacity 0.05, then ``TIE_OPAQUE``): identical rows give a ray
    bit-equal t in every copy, and a stack of 300 fills three chunks, so
    ties fall across the lanes of a chunk and across the visits of a
    group."""
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
    for k in range(layers):
        base = np.full(d, STACK_BASE, np.float64)
        base[2] = 0.01 * k
        pts = [base.copy()]
        for ax in [0, 1] + list(range(3, d)):
            v = base.copy()
            v[ax] += STACK_SIDE
            pts.append(v)
        mat = a.Material((0.9, 0.9, 1.0), opacity=float(rng.uniform(0.01,
                                                                     0.1)))
        protos.append(nt.TrianglePrototype([nt.Vector(*p) for p in pts],
                                           mat))
    for (base, side), mat in ((TIE_GLASS, a.Material((0.8, 0.8, 1.0),
                                                     opacity=0.05)),
                              (TIE_OPAQUE, solid)):
        pts = [nt.Vector(*p) for p in _tie_vertices(d, base, side)]
        protos += [nt.TrianglePrototype(pts, mat) for _ in range(ties)]
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, -8))
    scene.set_camera(cam)
    return two_lights(scene, nt)


STACK_BASE, STACK_SIDE = 4.0, 8.0
# the tie stacks: (first vertex on axes 0, 1 and 2, side)
TIE_GLASS, TIE_OPAQUE = ((-0.6, -0.6, -3.5), 1.6), ((-0.8, -0.8, -3.2), 2.0)


def _tie_vertices(d, base, side):
    """A simplex in the plane x_2 = base[2]: ``base`` (-0.05 on the axes
    past 2, so the view's 3-space crosses it) and ``base`` + ``side`` along
    each other axis."""
    b = np.full(d, -0.05)
    b[:3] = base
    pts = [b.copy()]
    for ax in [0, 1] + list(range(3, d)):
        v = b.copy()
        v[ax] += side
        pts.append(v)
    return pts


def _chunk_t(res, d, o, dv, chunk):
    """t and validity (skip ids aside) of rays ``o``/``dv`` (d, n) against
    the 128 slots of pool chunk ``chunk``: (n, 128) each, rounded as the
    walks round."""
    n = o.shape[1]
    skip = torch.full((1, n, 1), -1, dtype=torch.int32, device=o.device)
    t, valid = prk._chunk_hits_vals(
        d, False, res["gt"][chunk][None], res["ci"][chunk][None],
        res["ids"][chunk, 0][None], o[:, None, :, None], dv[:, None, :, None],
        skip)
    return t[0], valid[0]


def _occlusion_cases(d, dev):
    """One wavefront of seven 512-ray blocks over ``_stack_scene(d)`` (its
    pool forced over the line by the caller) that holds the streaming
    occlusion walks' corner cases, block by block:
      0. one ray stays undecided to the end (an unblocked shadow ray among
         511 that block at once);
      1. every ray blocks in the block's first visited chunk (origins just
         before an opaque triangle seen from the camera, distance past
         it);
      2. half the origins NaN (the bounce wavefront's misses), ldist kept;
      3. ldist exactly the t of the triangle ahead (even rays: t < ldist
         fails) or the next float (odd rays: it holds);
      4. the triangle ahead is the ray's own skip id (even rays), or not;
      5. rays along the glass stack, past its end;
      6. one ray of ldist NaN (the bound is NaN: no chunk is visited).
    Returns (res, (oT, dT, ldist, skip), facts) with facts the twin's view
    of what each case is."""
    scene = _stack_scene(d)
    cfg, arrs, cam_o, oT, dT = _primary(scene, dev)
    assert "res_is_hbm" in arrs and cfg.has_transparency
    pctx = pwf.primary_ctx(arrs, cfg, cam_o)
    res = pwf._res_dict(arrs)
    n_all = oT.shape[1]
    skip_all = torch.full((n_all,), -1, dtype=torch.int32, device=dev)
    kw = dict(order=pctx["order"], sh=pctx["sh_res"])
    t, slot, tt, ts, _v = prk.nearest_hit_transparent_hbm_ref(
        res, oT, dT, skip_all, d, 8, **kw)
    all_t = torch.cat([torch.where(slot >= 0, t, float("inf"))[None], tt])
    k = all_t.argmin(dim=0, keepdim=True)
    first = torch.gather(all_t, 0, k)[0]
    fslot = torch.gather(torch.cat([slot[None], ts]), 0, k)[0]
    found = torch.isfinite(first)
    ids = res["ids"][:, 0].reshape(-1)
    pid = torch.where(found, ids[fslot.clamp(min=0).long()], -1) \
        .to(torch.int32)
    point = oT + torch.where(found, first, 0.0)[None, :] * dT
    gl = (-arrs["gl_dir"][0])[:, None].expand_as(point).contiguous()
    exit_t = prk._scene_exit_T(point, gl, res["b_lo"], res["b_hi"])
    sl = torch.where(found, exit_t, 0.0)
    sb, _sf, _sv = prk.occluded_transparent_hbm_ref(res, point, gl, sl, pid,
                                                    d)
    free = torch.nonzero(found & ~sb & (sl > 0)).flatten()
    assert free.numel()
    # origins 1e-2 .. 2e-2 before an opaque triangle seen from the camera,
    # the first chunk its block visits holding it
    opa = res["opa"][:, 0].reshape(-1)
    eps = 1e-2 * (1 + torch.arange(512, device=dev) / 512.0)
    near = None
    tried = set()
    for r in torch.nonzero(found & (opa[fslot.clamp(min=0).long()] >= 1)) \
            .flatten().tolist():
        chunk, lane = divmod(int(fslot[r]), prk.CK)
        if (chunk, lane) in tried:
            continue
        tried.add((chunk, lane))
        o = point[:, r:r + 1] - eps[None, :] * dT[:, r:r + 1]
        dv = dT[:, r:r + 1].expand(-1, 512).contiguous()
        ld = 2 * eps
        w = prk._occlusion_inputs(res, o, dv, ld, skip_all[:512], d, None)
        emin = prk._entry_minima(w, o.reshape(d, 1, 512, 1),
                                 dv.reshape(d, 1, 512, 1))[0]
        cands = torch.nonzero(emin < ld.max()).flatten()
        tc, vc = _chunk_t(res, d, o, dv, chunk)
        if cands.numel() and int(w["order"][cands[0]]) == chunk and \
                bool((vc[:, lane] & (tc[:, lane] < ld)).all()):
            near = (o, dv, tc[:, lane], ids[chunk * prk.CK + lane])
            break
    assert near is not None, "no opaque triangle heads a block's visits"
    o1, dv1, t_ahead, id_ahead = near
    none = skip_all[:512]
    blocks = []
    # 0. one undecided ray among 511 that block at once
    blocks.append((torch.cat([point[:, free[:1]], o1[:, 1:]], dim=1),
                   torch.cat([gl[:, free[:1]], dv1[:, 1:]], dim=1),
                   torch.cat([sl[free[:1]], 2 * eps[1:]]),
                   torch.cat([pid[free[:1]], none[1:]])))
    # 1. every ray blocks in the block's first visited chunk
    blocks.append((o1, dv1, 2 * eps, none))
    # 2. NaN origins (every other ray)
    nan_o = o1.clone()
    nan_o[:, ::2] = float("nan")
    blocks.append((nan_o, dv1, 2 * eps, none))
    # 3. ldist = t of the triangle ahead, or the next float
    ld_t = torch.where(torch.arange(512, device=dev) % 2 == 0, t_ahead,
                       torch.nextafter(t_ahead, torch.tensor(
                           float("inf"), device=dev)))
    blocks.append((o1, dv1, ld_t, none))
    # 4. the triangle ahead is the ray's own skip id (even rays)
    own = torch.where(torch.arange(512, device=dev) % 2 == 0, id_ahead,
                      -1).to(torch.int32)
    blocks.append((o1, dv1, 2 * eps, own))
    # 5. along the stack (axis 2), from before it to past its end
    g = np.random.RandomState(d)
    o5 = np.full((d, 512), STACK_BASE, np.float32)
    for ax in [0, 1] + list(range(3, d)):
        o5[ax] += g.uniform(0.1, 0.8 * STACK_SIDE / (d - 1), 512) \
            .astype(np.float32)
    o5[2] = -1.0
    dv5 = np.zeros((d, 512), np.float32)
    dv5[2] = 1.0
    blocks.append((torch.as_tensor(o5, device=dev),
                   torch.as_tensor(dv5, device=dev),
                   torch.full((512,), 10.0, device=dev), none))
    # 6. one ray of NaN ldist
    nan_ld = 2 * eps
    nan_ld[7] = float("nan")
    blocks.append((o1, dv1, nan_ld, none))
    oT_c, dT_c, ld_c, sk_c = (torch.cat(x, dim=-1).contiguous()
                              for x in zip(*blocks))
    # the twin's view of each case
    b, f, v = prk.occluded_transparent_hbm_ref(res, oT_c, dT_c, ld_c, sk_c,
                                               d)
    b = b.reshape(7, 512)
    facts = dict(
        one_undecided=not bool(b[0, 0]) and bool(b[0, 1:].all()),
        first_visit=bool(b[1].all()),
        nan_block_walked=int(v[2]) > 0,
        nan_bound_visits=int(v[6]),
        at_t_unblocked=int((~b[3, ::2]).sum()),
        at_next_blocked=int(b[3, 1::2].sum()),
        own_skip_unblocked=int((~b[4, ::2]).sum()),
        other_blocked=int(b[4, 1::2].sum()))
    # a chunk of the stack whose 128 slots all filter some ray of block 5
    full = 0
    o5t, dv5t = oT_c[:, 2560:2561], dT_c[:, 2560:2561]
    for c in range(res["gt"].shape[0]):
        tc, vc = _chunk_t(res, d, o5t, dv5t, c)
        ok = vc[0] & (tc[0] < 10.0) & (res["opa"][c, 0] < 1)
        full += int(ok.all())
    facts["glass_only_chunks"] = full
    facts["stack_filt"] = float(f[2560])
    return res, (oT_c, dT_c, ld_c, sk_c), facts


@pytest.mark.parametrize("d", [3, 6, 8])
def test_streaming_occlusion_walks_corner_cases(cuda, d, monkeypatch):
    """The redesigned kernels 2.6 and 2.8 on the corner cases of
    ``_occlusion_cases`` (a pool over the line at d = 3, 6 and 8: the ring
    holds 8, then fewer slots): each equals its twin bit for bit (blocked,
    filt, visits) and the entry of kernel 2.2 / 2.4 on the same inputs;
    2.2's entry (``occluded``, which launches 2.6's body on this small
    pool) equals its own twin ``occluded_ref``."""
    monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    res, (oT, dT, ld, sk), facts = _occlusion_cases(d, cuda)
    print(f"d = {d}: {facts}")
    assert facts["one_undecided"] and facts["first_visit"]
    assert facts["nan_block_walked"] and facts["nan_bound_visits"] == 0
    assert facts["at_t_unblocked"] and facts["at_next_blocked"]
    assert facts["own_skip_unblocked"] and facts["other_blocked"]
    assert facts["glass_only_chunks"] >= 1 and facts["stack_filt"] < 1
    args = (res, oT, dT, ld, sk, d)
    for hbm, ref, resident in (
            (prk.occluded_hbm, prk.occluded_hbm_ref, prk.occluded),
            (prk.occluded_transparent_hbm, prk.occluded_transparent_hbm_ref,
             prk.occluded_transparent)):
        before = hbm.launches
        got = hbm(*args)
        assert hbm.launches == before + 1
        torch.cuda.synchronize()
        _equal(got, ref(*args))
        _equal(got, resident(*args))
    before = prk.occluded.launches
    got = prk.occluded(*args)
    assert prk.occluded.launches == before + 1
    torch.cuda.synchronize()
    _equal(got, prk.occluded_ref(*args))


@pytest.mark.parametrize("d", [3, 6, 8])
def test_resident_nearest_entry_corner_cases(cuda, d, monkeypatch):
    """Kernel 2.1's entry (``nearest_hit``, which launches 2.5's body) on
    the corner cases of ``_nearest_cases`` -- ties across lanes and visits,
    the winner skipped, NaN origins, a dead block, a live block without
    hits -- with every live ray active and with every other one, and on the
    frame's primary wavefront with the shared rows, with and without an
    active mask: it equals its twin ``nearest_hit_ref`` bit for bit (t,
    slots, visits), and the streaming entry on the same inputs."""
    monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    res, (oT, dT, sk), actives, facts = _nearest_cases(d, cuda)
    assert facts["tie_lanes"] >= 2 and facts["skip_moves"]
    assert facts["nan_hits"] == 0 and facts["dead_visits"] == 0
    for active in actives:
        args = (res, oT, dT, sk, d)
        before = prk.nearest_hit.launches
        got = prk.nearest_hit(*args, active=active)
        assert prk.nearest_hit.launches == before + 1
        torch.cuda.synchronize()
        _equal(got, prk.nearest_hit_ref(*args, active=active))
        _equal(got, prk.nearest_hit_hbm(*args, active=active))
    scene = _stack_scene(d, ties=300)
    cfg, arrs, cam_o, oT, dT = _primary(scene, cuda)
    pctx = pwf.primary_ctx(arrs, cfg, cam_o)
    res = pwf._res_dict(arrs)
    skip = torch.full((oT.shape[1],), -1, dtype=torch.int32, device=cuda)
    half = torch.arange(oT.shape[1], device=cuda) % 3 != 0
    for kw in (dict(order=pctx["order"], sh=pctx["sh_res"]),
               dict(order=pctx["order"], sh=pctx["sh_res"], active=half)):
        got = prk.nearest_hit(res, oT, dT, skip, d, **kw)
        torch.cuda.synchronize()
        assert int((got[1] >= 0).sum()) > 100
        _equal(got, prk.nearest_hit_ref(res, oT, dT, skip, d, **kw))
        _equal(got, prk.nearest_hit_hbm(res, oT, dT, skip, d, **kw))


@pytest.mark.parametrize("d", [3, 6, 8])
def test_resident_filtered_occlusion_entry_corner_cases(cuda, d,
                                                         monkeypatch):
    """Kernel 2.4's entry (``occluded_transparent``, which launches 2.8's
    body) on the corner cases of ``_occlusion_cases``: it equals its twin
    ``occluded_transparent_ref`` bit for bit (blocked, filt, visits), and
    the streaming entry on the same inputs."""
    monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    res, (oT, dT, ld, sk), _facts = _occlusion_cases(d, cuda)
    args = (res, oT, dT, ld, sk, d)
    before = prk.occluded_transparent.launches
    got = prk.occluded_transparent(*args)
    assert prk.occluded_transparent.launches == before + 1
    torch.cuda.synchronize()
    _equal(got, prk.occluded_transparent_ref(*args))
    _equal(got, prk.occluded_transparent_hbm(*args))


def _aim(origin, points):
    """Unit directions (d, n) from ``origin`` (d,) to ``points`` (d, n)."""
    v = points - origin[:, None]
    return v / torch.sqrt((v * v).sum(dim=0, keepdim=True))


def _nearest_cases(d, dev):
    """One wavefront of eight 512-ray blocks over ``_stack_scene(d,
    ties=300)`` (its pool forced over the line by the caller) that holds
    the streaming nearest-hit walks' corner cases, block by block:
      0. rays from the camera aimed into both tie stacks: 300 glass copies
         at one t, then 300 opaque copies at one t, across lanes and
         visits;
      1. rays along the glass stack of ``_stack_scene`` (256 layers, 128 a
         chunk), past its end;
      2. block 0 with every other origin NaN;
      3. block 0 with the even rays' skip id the opaque copy that wins
         there: the next copy at the same t wins;
      4. rays along axis 0 in the empty plane x_2 = -3 between the tie
         stacks and the rest, parallel to the stacks: live, no hit;
      5. rays inactive in every ``active`` set: a dead block;
      6. the frame's first 512 primary rays;
      7. rays from block 0's opaque hit points in random directions.
    Returns (res, (oT, dT, skip), [active, half-live active], facts) with
    facts the twins' view of what each case is."""
    scene = _stack_scene(d, ties=300)
    cfg, arrs, cam_o, oT, dT = _primary(scene, dev)
    assert "res_is_hbm" in arrs and cfg.has_transparency
    res = pwf._res_dict(arrs)
    g = np.random.RandomState(d + 40)
    none = torch.full((512,), -1, dtype=torch.int32, device=dev)

    def aimed_at(base, side, n):
        lam = g.uniform(0.15, 0.35, (2, n))
        pts = np.stack([_tie_vertices(d, base, side)[0]] * n, axis=1)
        pts[0] += lam[0] * side
        pts[1] += lam[1] * side
        pts[3:] = 0.0
        return torch.as_tensor(pts.astype(np.float32), device=dev)

    o0 = cam_o.float()[:, None].expand(d, 512).contiguous()
    d0 = _aim(cam_o.float(), aimed_at(*TIE_OPAQUE, 512)).contiguous()
    # 1. along the layers (axis 2), from before them to past their end
    o1 = np.full((d, 512), STACK_BASE, np.float32)
    for ax in [0, 1] + list(range(3, d)):
        o1[ax] += g.uniform(0.1, 0.8 * STACK_SIDE / (d - 1), 512) \
            .astype(np.float32)
    o1[2] = -1.0
    d1 = np.zeros((d, 512), np.float32)
    d1[2] = 1.0
    o1, d1 = (torch.as_tensor(x, device=dev) for x in (o1, d1))
    # 2. NaN origins
    o2 = o0.clone()
    o2[:, ::2] = float("nan")
    # 3. the winning opaque copy skipped
    w0 = prk._walk_inputs(res, o0, d0, none, d, None, None, None)
    t0, s0, _v = prk._walk_ref(w0)
    assert bool((s0 >= 0).all())
    win = res["ids"][:, 0].reshape(-1)[s0.long()].to(torch.int32)
    even = torch.arange(512, device=dev) % 2 == 0
    sk3 = torch.where(even, win, -1).to(torch.int32)
    # 4. along axis 0 between the tie stacks and the rest
    o4 = np.full((d, 512), -0.05, np.float32)
    o4[0] = -2.5
    o4[1] = g.uniform(-0.5, 0.5, 512)
    o4[2] = -3.0
    d4 = np.zeros((d, 512), np.float32)
    d4[0] = 1.0
    o4, d4 = (torch.as_tensor(x, device=dev) for x in (o4, d4))
    # 7. random directions from block 0's hit points
    p7 = o0 + t0[None, :] * d0
    d7 = pwf._unitT(torch.as_tensor(g.normal(size=(d, 512))
                                    .astype(np.float32), device=dev))
    blocks = [(o0, d0, none), (o1, d1, none), (o2, d0, none), (o0, d0, sk3),
              (o4, d4, none), (o0, d0, none), (oT[:, :512], dT[:, :512], none),
              (p7, d7, win)]
    oT_c, dT_c, sk_c = (torch.cat(x, dim=-1).contiguous()
                        for x in zip(*blocks))
    blk = torch.arange(8 * 512, device=dev) // 512
    active = blk != 5
    half = active & (torch.arange(8 * 512, device=dev) % 2 == 0)
    # the twins' view of each case
    t, s, v = prk.nearest_hit_hbm_ref(res, oT_c, dT_c, sk_c, d,
                                      active=active)
    tt, ts = prk.nearest_hit_transparent_hbm_ref(
        res, oT_c, dT_c, sk_c, d, 8, active=active)[2:4]
    # block 0, ray 1: the chunks and lanes whose t equals its nearest hit
    tc, vc = _chunk_t_all(res, d, oT_c[:, 1:2], dT_c[:, 1:2])
    at_best = vc & (tc == t[1])
    facts = dict(
        tie_lanes=int(at_best.sum()), tie_chunks=int(at_best.any(dim=1).sum()),
        glass_ties=int((tt[:, 1] == tt[0, 1]).sum()),
        skip_moves=int((s[1536:2048:2] != s[0:512:2]).sum()),
        skip_same_t=bool(torch.equal(t[1536:2048:2], t[0:512:2])),
        nan_hits=int((s[1024:1536:2] >= 0).sum()),
        miss_hits=int((s[2048:2560] >= 0).sum() + (ts[:, 2048:2560] >= 0)
                      .sum()),
        miss_live=bool(prk._walk_inputs(res, oT_c, dT_c, sk_c, d, None,
                                        active, None)["blive"][4] != 0),
        dead_visits=int(v[5]),
        layers_filled=int((ts[:, 512:1024] >= 0).all(dim=0).sum()))
    tcs, vcs = _chunk_t_all(res, d, oT_c[:, 512:513], dT_c[:, 512:513])
    glass = res["opa"][:, 0] < 1
    facts["glass_only_chunks"] = int((vcs & glass).all(dim=1).sum())
    return res, (oT_c, dT_c, sk_c), [active, half], facts


def _chunk_t_all(res, d, o, dv):
    """``_chunk_t`` of one ray (d, 1) against every chunk of the pool:
    (chunks, 128) t and validity."""
    n = res["gt"].shape[0]
    skip = torch.full((n, 1, 1), -1, dtype=torch.int32, device=o.device)
    t, valid = prk._chunk_hits_vals(
        d, False, res["gt"], res["ci"], res["ids"][:, 0],
        o[:, None, :, None].expand(d, n, 1, 1),
        dv[:, None, :, None].expand(d, n, 1, 1), skip)
    return t[:, 0], valid[:, 0]


@pytest.mark.parametrize("d", [3, 6, 8])
def test_streaming_nearest_walks_corner_cases(cuda, d, monkeypatch):
    """The redesigned kernels 2.5 and 2.7 on the corner cases of
    ``_nearest_cases`` (a pool over the line at d = 3, 6 and 8), with every
    live ray active and with every other one: each equals its twin bit for
    bit (t, slots, the K slots by position for K = 2 and 8, visits), 2.5
    equals the resident kernel 2.1 and 2.7 has 2.3's t and opaque slot.
    Then the frame's primary wavefront with the shared rows."""
    monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    res, (oT, dT, sk), actives, facts = _nearest_cases(d, cuda)
    print(f"d = {d}: {facts}")
    assert facts["tie_lanes"] >= 2 and facts["tie_chunks"] >= 2
    assert facts["glass_ties"] >= 2
    assert facts["skip_moves"] and facts["skip_same_t"]
    assert facts["nan_hits"] == 0
    assert facts["miss_live"] and facts["miss_hits"] == 0
    assert facts["dead_visits"] == 0
    assert facts["glass_only_chunks"] >= 1 and facts["layers_filled"]
    for active in actives:
        kw = dict(active=active)
        before = prk.nearest_hit_hbm.launches
        got = prk.nearest_hit_hbm(res, oT, dT, sk, d, **kw)
        assert prk.nearest_hit_hbm.launches == before + 1
        torch.cuda.synchronize()
        _equal(got, prk.nearest_hit_hbm_ref(res, oT, dT, sk, d, **kw))
        _equal(got, prk.nearest_hit(res, oT, dT, sk, d, **kw))
        for K in (2, 8):
            before = prk.nearest_hit_transparent_hbm.launches
            got = prk.nearest_hit_transparent_hbm(res, oT, dT, sk, d, K, **kw)
            assert prk.nearest_hit_transparent_hbm.launches == before + 1
            torch.cuda.synchronize()
            _equal(got, prk.nearest_hit_transparent_hbm_ref(res, oT, dT, sk,
                                                            d, K, **kw))
            _equal(got[:2], prk.nearest_hit_transparent(res, oT, dT, sk, d,
                                                        K, **kw)[:2])
    scene = _stack_scene(d, ties=300)
    cfg, arrs, cam_o, oT, dT = _primary(scene, cuda)
    pctx = pwf.primary_ctx(arrs, cfg, cam_o)
    res = pwf._res_dict(arrs)
    skip = torch.full((oT.shape[1],), -1, dtype=torch.int32, device=cuda)
    kw = dict(order=pctx["order"], sh=pctx["sh_res"])
    got = prk.nearest_hit_hbm(res, oT, dT, skip, d, **kw)
    _equal(got, prk.nearest_hit_hbm_ref(res, oT, dT, skip, d, **kw))
    _equal(got, prk.nearest_hit(res, oT, dT, skip, d, **kw))
    for K in (2, 8):
        got = prk.nearest_hit_transparent_hbm(res, oT, dT, skip, d, K, **kw)
        _equal(got, prk.nearest_hit_transparent_hbm_ref(res, oT, dT, skip, d,
                                                        K, **kw))
        _equal(got[:2], prk.nearest_hit_transparent(res, oT, dT, skip, d, K,
                                                    **kw)[:2])


@pytest.mark.parametrize("d", [3, 4, 6, 8])
def test_transparent_walk_corner_cases(cuda, d, monkeypatch):
    """Kernel 2.3 (``nearest_hit_transparent``: 2.7's body in groups of one
    candidate) on the corner cases of ``_nearest_cases`` -- rays along the
    256-layer glass stack, which cross more glass than K slots hold; 300
    exactly tied coplanar glass copies and 300 opaque ones, across lanes
    and visits; the winner skipped; NaN origins; a dead block; a live block
    without hits -- with every live ray active and with every other one,
    and on the frame's primary wavefront with the shared rows, for K = 1, 3
    and 8: it equals its twin ``nearest_hit_transparent_ref`` bit for bit
    (t, the slot, every K slot by position, visits)."""
    monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    res, (oT, dT, sk), actives, facts = _nearest_cases(d, cuda)
    assert facts["glass_ties"] >= 2 and facts["dead_visits"] == 0
    assert facts["glass_only_chunks"] >= 1 and facts["layers_filled"]
    scene = _stack_scene(d, ties=300)
    cfg, arrs, cam_o, poT, pdT = _primary(scene, cuda)
    pctx = pwf.primary_ctx(arrs, cfg, cam_o)
    pres = pwf._res_dict(arrs)
    pskip = torch.full((poT.shape[1],), -1, dtype=torch.int32, device=cuda)
    runs = [(res, oT, dT, sk, dict(active=a)) for a in actives] + \
        [(pres, poT, pdT, pskip, dict(order=pctx["order"],
                                      sh=pctx["sh_res"]))]
    for K in (1, 3, 8):
        for res_, o_, d_, s_, kw in runs:
            before = prk.nearest_hit_transparent.launches
            got = prk.nearest_hit_transparent(res_, o_, d_, s_, d, K, **kw)
            assert prk.nearest_hit_transparent.launches == before + 1
            torch.cuda.synchronize()
            ref = prk.nearest_hit_transparent_ref(res_, o_, d_, s_, d, K,
                                                  **kw)
            print(f"d = {d}, K = {K}, {sorted(kw)}: "
                  f"{prk.nearest_hit_transparent_ref.replaced} slots "
                  f"replaced, {int((ref[3] >= 0).sum())} filled")
            if "active" in kw:
                # block 1's rays cross the stack's 256 glass layers: more
                # glass than the K slots hold
                assert int((ref[3][:, 512:1024] >= 0).all(dim=0).sum())
            _equal(got, ref)


def test_resident_entries_launch_info(cuda):
    """Kernels 2.2 and 2.3 as they launch at every d: 2.2 as 2.6 (two
    512-thread blocks an SM of at most 64 registers a thread, a ring of at
    least two slots); 2.3 with the ring of its groups of one, two slots,
    and 2.7's blocks: two of at most 64 registers a thread but at d = 8,
    whose K slots take 32 KiB, one of at most 128."""
    for d in range(3, 9):
        info = prk.stream_info("occluded", d)
        print(f"2.2 d = {d}: {info}")
        assert info == prk.stream_info("occluded_hbm", d)
        assert info["blocks_per_sm"] >= 2 and info["registers"] <= 64
        assert info["ring_slots"] >= 2
        for shared in (False, True):
            info = prk.stream_info("nearest_hit_transparent", d, shared)
            print(f"2.3 shared={shared} d = {d}: {info}")
            assert info["ring_slots"] == 2
            assert info["blocks_per_sm"] >= (1 if d == 8 else 2)
            assert info["registers"] <= (128 if d == 8 else 64)


# pair_test_warp (stream_walk.cuh, every chunk walk) against its twin
# `_chunk_hits_vals`: every ray x slot of a chunk from global memory, a
# lane's slot rotated by its lane, some pairs not wanted on the way in (as a
# decided ray or the skip id leaves them); the verdict, and t where it holds
_PAIR_PROBE = r"""
#include "stream_walk.cuh"

namespace {
using namespace ntr;

template <int D, int RPT, bool SHARED, bool PRE>
__global__ void pair_probe(const float* gt, const float* ci, const int* ids,
                           const float* oT, const float* dT, const float* ld,
                           int R, unsigned char* got, float* tgot) {
  const int base = (blockIdx.x * blockDim.x + threadIdx.x) * RPT;
  const int lane = threadIdx.x & 31;
  float o[RPT][D], dv[RPT][D], rl[RPT];
  for (int c = 0; c < RPT; ++c) {
    const int r = base + c < R ? base + c : R - 1;
    for (int k = 0; k < D; ++k) {
      o[c][k] = oT[(size_t)k * R + r];
      dv[c][k] = dT[(size_t)k * R + r];
    }
    rl[c] = ld[r];
  }
  const Chunk ch{gt, ci, ids, nullptr};
  for (int j = 0; j < CK; ++j) {
    const int l = (j + lane) % CK;
    bool go[RPT];
    float tw[RPT];
    for (int c = 0; c < RPT; ++c)
      go[c] = base + c < R && (base + c + l) % 5 != 0;
    pair_test_warp<D, RPT, SHARED, PRE>(ch, l, o, dv, rl, go, tw);
    for (int c = 0; c < RPT; ++c) {
      if (base + c >= R) continue;
      const size_t at = (size_t)(base + c) * CK + l;
      got[at] = go[c];
      tgot[at] = go[c] ? tw[c] : 0.f;
    }
  }
}

template <int D, int RPT, bool SHARED, bool PRE>
int launch(const float* gt, const float* ci, const int* ids, const float* oT,
           const float* dT, const float* ld, int R, unsigned char* got,
           float* tgot) {
  const int per = 128 * RPT;
  pair_probe<D, RPT, SHARED, PRE><<<(R + per - 1) / per, 128>>>(
      gt, ci, ids, oT, dT, ld, R, got, tgot);
  return (int)cudaDeviceSynchronize();
}

template <int D, bool SHARED, bool PRE>
int launch_rpt(int rpt, const float* gt, const float* ci, const int* ids,
               const float* oT, const float* dT, const float* ld, int R,
               unsigned char* got, float* tgot) {
  return rpt == 2 ? launch<D, 2, SHARED, PRE>(gt, ci, ids, oT, dT, ld, R,
                                              got, tgot)
                  : launch<D, 1, SHARED, PRE>(gt, ci, ids, oT, dT, ld, R,
                                              got, tgot);
}

template <int D>
int launch_d(int rpt, int shared, int pre, const float* gt, const float* ci,
             const int* ids, const float* oT, const float* dT,
             const float* ld, int R, unsigned char* got, float* tgot) {
  if (shared)
    return pre ? launch_rpt<D, true, true>(rpt, gt, ci, ids, oT, dT, ld, R,
                                           got, tgot)
               : launch_rpt<D, true, false>(rpt, gt, ci, ids, oT, dT, ld, R,
                                            got, tgot);
  return pre ? launch_rpt<D, false, true>(rpt, gt, ci, ids, oT, dT, ld, R,
                                          got, tgot)
             : launch_rpt<D, false, false>(rpt, gt, ci, ids, oT, dT, ld, R,
                                           got, tgot);
}
}  // namespace

extern "C" int ntr_pair_probe(int d, int rpt, int shared, int pre,
                              const float* gt, const float* ci,
                              const int* ids, const float* oT,
                              const float* dT, const float* ld, int R,
                              unsigned char* got, float* tgot) {
#define NTR_CASE(DD)                                                         \
  case DD:                                                                   \
    return launch_d<DD>(rpt, shared, pre, gt, ci, ids, oT, dT, ld, R, got,   \
                        tgot);
  switch (d) {
    NTR_CASE(3)
    NTR_CASE(6)
    NTR_CASE(8)
  }
#undef NTR_CASE
  return -1;
}
"""


@pytest.fixture(scope="module")
def pair_probe(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ctypes
    import subprocess
    from ntracer_tpu_torch.engine import _build
    out = tmp_path_factory.mktemp("pair_probe")
    src, obj, lib = (str(out / n) for n in ("probe.cu", "probe.o",
                                             "probe.so"))
    with open(src, "w") as f:
        f.write(_PAIR_PROBE)
    nvcc = _build.find_nvcc()
    compile_ = _build.nvcc_command(src, obj, nvcc)
    subprocess.run(compile_[:1] + ["-I", _build.CSRC_DIR] + compile_[1:],
                   check=True, capture_output=True)
    subprocess.run(_build.link_command([obj], lib, nvcc), check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib).ntr_pair_probe
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _pair_probe_all(pair_probe, d, shared, gt, ci, ids, oT, dT, ld):
    """Run the probe on every chunk for one and two rays a lane, with and
    without the pre-test, and hold pair_test_warp to its twin
    `_chunk_hits_vals` on the card: the verdicts (the twin's valid, t <
    cut, and the pairs the probe wants) equal, and t bit for bit where the
    pair holds.  Returns the pairs that hold."""
    R = oT.shape[1]
    dev = oT.device
    skip = torch.full((1, R, 1), -1, dtype=torch.int32, device=dev)
    lanes = torch.arange(prk.CK, device=dev)
    rays = torch.arange(R, device=dev)
    wanted = (rays[:, None] + lanes[None, :]) % 5 != 0
    hits = 0
    for k in range(gt.shape[0]):
        t, valid = prk._chunk_hits_vals(
            d, shared, gt[k][None], ci[k][None], ids[k, 0][None],
            oT[:, None, :, None], dT[:, None, :, None], skip)
        want = wanted & valid[0] & (t[0] < ld[:, None])
        twant = torch.where(want, t[0], 0.0)
        for rpt, pre in ((1, 1), (2, 1), (1, 0), (2, 0)):
            got = torch.zeros((R, prk.CK), dtype=torch.uint8, device=dev)
            tgot = torch.ones((R, prk.CK), device=dev)
            err = pair_probe(d, rpt, int(shared), pre, gt[k].data_ptr(),
                             ci[k].data_ptr(), ids[k].data_ptr(),
                             oT.data_ptr(), dT.data_ptr(), ld.data_ptr(), R,
                             got.data_ptr(), tgot.data_ptr())
            assert err == 0
            assert torch.equal(got.bool(), want), (
                rpt, pre, k, int((got.bool() != want).sum()))
            assert torch.equal(tgot.view(torch.int32),
                               twant.view(torch.int32)), (rpt, pre, k)
            hits += int(got.sum())
    return hits


@pytest.mark.parametrize("d", [3, 6, 8])
def test_pair_test_warp_equals_pair_test(cuda, pair_probe, d, monkeypatch):
    """The chunk walks' pair test (with or without the pre-test before the
    division, edges only while a lane can pass, sums from the first
    product, a cut) decides every pair as its twin ``_chunk_hits_vals``
    with t < cut does and gives the twin's t, for one and two rays a lane,
    on every chunk of ``_occlusion_cases(d)`` (NaN
    origins, ldist equal to a hit's t, glass stacks) with its shadow rays,
    and in the shared form (offset rows holding the origin dots) on every
    chunk of ``_stack_scene(d, ties=300)`` with its primary rays, cut at
    random distances, 0, +inf and NaN."""
    monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    res, rays, _facts = _occlusion_cases(d, cuda)
    oT, dT, ld = (x.contiguous() for x in rays[:3])
    gt, ci, ids = (res[k].contiguous() for k in ("gt", "ci", "ids"))
    assert gt.shape[1] >= d * d
    assert _pair_probe_all(pair_probe, d, False, gt, ci, ids, oT, dT, ld) > 0
    scene = _stack_scene(d, ties=300)
    cfg, arrs, cam_o, oT, dT = _primary(scene, cuda)
    pctx = pwf.primary_ctx(arrs, cfg, cam_o)
    res = pwf._res_dict(arrs)
    oT, dT = oT[:, :4096].contiguous(), dT[:, :4096].contiguous()
    g = np.random.RandomState(d)
    cut = g.uniform(0, 20, 4096).astype(np.float32)
    cut[::7] = np.inf
    cut[3::11] = 0.0
    cut[5::13] = np.nan
    cut = torch.as_tensor(cut, device=cuda)
    sh = pctx["sh_res"].contiguous()
    gt, ids = res["gt"].contiguous(), res["ids"].contiguous()
    assert _pair_probe_all(pair_probe, d, True, gt, sh, ids, oT, dT,
                           cut) > 0


def test_streaming_kernels_launch_info(cuda):
    """Kernels 2.5 and 2.7 (both variants) as they launch at every d: a
    ring of at least two slots, and two 512-thread blocks an SM of at most
    64 registers a thread wherever the ring's two slots fit beside the
    kernel's shared memory; 2.7 at d = 8, whose K slots take 32 KiB, runs
    one block of at most 128 registers a thread."""
    for name in ("nearest_hit_hbm", "nearest_hit_transparent_hbm"):
        for shared in (False, True):
            for d in range(3, 9):
                info = prk.stream_info(name, d, shared)
                print(f"{name} shared={shared} d = {d}: {info}")
                assert info["ring_slots"] >= 2
                one = name == "nearest_hit_transparent_hbm" and d == 8
                assert info["blocks_per_sm"] >= (1 if one else 2)
                assert info["registers"] <= (128 if one else 64)


def test_streaming_occlusion_kernels_two_blocks_an_sm(cuda):
    """The redesigned kernels fit two 512-thread blocks on an SM at every
    d (64 registers a thread at most), with a ring of at least two
    slots."""
    for filtered in (False, True):
        for d in range(3, 9):
            info = prk.stream_info(
                "occluded_transparent_hbm" if filtered else "occluded_hbm", d)
            print(f"{'2.8' if filtered else '2.6'} d = {d}: {info}")
            assert info["blocks_per_sm"] >= 2 and info["registers"] <= 64
            assert info["ring_slots"] >= 2


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


def _grid_corner_cases(d, dev, n=300, ties=600, seed=3):
    """Kernel 2.9's corner cases at dimension ``d``: ``n`` random simplices
    (chip_smoke.random_pool's spread) and ``ties`` identical copies of one
    simplex in the plane x_2 = -4 (``_tie_vertices``), in front of them
    from the camera at -8 on axis 2: 1,024 pool slots, two tiles, and the
    copies fill lanes of both.  Six 512-ray blocks from the camera:
      0. aimed at the copies: t tied across lanes and tiles;
      1. the same, each skipping the winner's pool id;
      2. the same with every other origin NaN;
      3. pointing away from the pool (a dead block: it runs no tile);
      4. through the pool's box, meeting no simplex (a live block without
         hits);
      5. aimed at random simplices of the second tile, with no valid pair
         in the first.
    Returns (kern, oT, dT, skip, sh, facts), facts the twin's view."""
    a = api()
    nt = a.NTracer(d)
    rng = np.random.RandomState(seed)
    pts = (rng.uniform(-2, 2, (n, 1, d))
           + rng.uniform(-0.7, 0.7, (n, d, d))).astype(np.float32)
    tie = np.asarray(_tie_vertices(d, (-0.6, -0.6, -4.0), 1.6), np.float32)
    allp = np.concatenate([pts, np.broadcast_to(tie, (ties, d, d))])
    mat = a.Material((0.8, 0.5, 0.9))
    scene = nt.build_composite_scene(
        nt.TrianglePrototype.batch_from_points(allp, [mat] * len(allp)))
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, -8))
    scene.set_camera(cam)
    cfg, arrs, flat = pwf.get_device_scene(scene, dev)
    kern = pwf._kern_dict(arrs)
    assert "kern_gt" in arrs and kern["gt"].shape[1] == 2 * gk.TRI_BLOCK
    cam_o = torch.as_tensor(np.asarray(scene._cam._origin, np.float32),
                            device=dev)
    smoke = _smoke()
    none = torch.full((512,), -1, dtype=torch.int32, device=dev)

    def twin(o, dv, sk, k_any=None):
        k = kern if k_any is None else dict(kern, k_any=k_any)
        return gk.nearest_hit_ref(k, o.contiguous(), dv.contiguous(), sk, d)

    o_cam = cam_o[:, None].expand(d, 512)
    d_tie = torch.as_tensor(smoke.aimed(cam_o.cpu().numpy(), tie[None],
                                        512), device=dev)
    t0, id0, _v = twin(o_cam, d_tie, none)
    winner = int(id0[0])
    g = kern["gt"]
    copies = torch.nonzero((g == g[:, winner:winner + 1]).all(dim=0) &
                           (kern["ci"] == kern["ci"][:, winner:winner + 1])
                           .all(dim=0)).flatten()
    skip1 = torch.full((512,), winner, dtype=torch.int32, device=dev)
    t1, id1, _v = twin(o_cam, d_tie, skip1)
    o_nan = o_cam.clone()
    o_nan[:, ::2] = float("nan")
    # 4: aimed at the plane of the copies, beside them, within the box
    side = np.asarray(_tie_vertices(d, (-2.5, -2.5, -4.0), 0.3), np.float32)
    d_miss = torch.as_tensor(smoke.aimed(cam_o.cpu().numpy(), side[None],
                                         4096, seed=5), device=dev)
    _t, idm, _v = twin(cam_o[:, None].expand(d, 4096), d_miss,
                       torch.full((4096,), -1, dtype=torch.int32,
                                  device=dev))
    exit_m = prk._scene_exit_T(cam_o[:, None].expand(d, 4096).contiguous(),
                               d_miss, kern["b_lo"], kern["b_hi"])
    miss = torch.nonzero((idm < 0) & (exit_m > 0)).flatten()
    assert miss.numel() > 0
    d_miss = d_miss[:, miss[torch.arange(512, device=dev) % miss.numel()]]
    # 5: aimed at random simplices of the second tile
    second = [i for i in range(gk.TRI_BLOCK, 2 * gk.TRI_BLOCK)
              if i not in set(copies.tolist())
              and np.linalg.norm(flat.arrays["tri_fn"][i]) > 0]
    verts = _pool_vertices(flat.arrays, second)
    d_2nd = torch.as_tensor(smoke.aimed(cam_o.cpu().numpy(), verts, 4096,
                                        seed=7), device=dev)
    o4k = cam_o[:, None].expand(d, 4096)
    sk4k = torch.full((4096,), -1, dtype=torch.int32, device=dev)
    _t, ids_all, _v = twin(o4k, d_2nd, sk4k)
    only_first = kern["k_any"].clone()
    only_first[1] = 0
    _t, ids_first, _v = twin(o4k, d_2nd, sk4k, k_any=only_first)
    keep = torch.nonzero((ids_all >= gk.TRI_BLOCK) & (ids_first < 0)) \
        .flatten()
    assert keep.numel() > 0
    d_2nd = d_2nd[:, keep[torch.arange(512, device=dev) % keep.numel()]]
    oT = torch.cat([o_cam, o_cam, o_nan, o_cam, o_cam, o_cam], dim=1)
    dT = torch.cat([d_tie, d_tie, d_tie, -d_tie, d_miss, d_2nd], dim=1)
    skip = torch.cat([none, skip1, none, none, none, none])
    oT, dT = oT.contiguous(), dT.contiguous()
    t, ids, tiles = gk.nearest_hit_ref(kern, oT, dT, skip, d)
    ids = ids.reshape(6, 512)
    facts = dict(
        copies=int(copies.numel()),
        copy_tiles=len(set((copies // gk.TRI_BLOCK).tolist())),
        tied_winner=bool((ids[0] == int(copies.min())).all()),
        skipped_winner=bool((ids[1] == int(copies[1])).all()),
        nan_hits=int((ids[2, ::2] >= 0).sum()),
        dead_tiles=int(tiles[3]),
        live_no_hit=int(tiles[4]) > 0 and bool((ids[4] < 0).all()),
        second_tile=bool((ids[5] >= gk.TRI_BLOCK).all()))
    sh = gk.shared_rows(kern["gt"], kern["ci"], cam_o, d)
    return kern, oT, dT, skip, sh, facts


def _pool_vertices(a, ids):
    """The vertices (m, d, d) of pool triangles ``ids`` of the flat arrays
    ``a``: p1, and the points where the edge planes meet the face plane
    (vertex k + 1 is where edge plane k reads 1 and the others 0)."""
    out = []
    for i in ids:
        d = a["tri_fn"].shape[1]
        m = np.concatenate([a["tri_fn"][i][None], a["tri_en"][i]]) \
            .astype(np.float64)
        en_p1 = a["tri_en"][i].astype(np.float64) @ \
            a["tri_p1"][i].astype(np.float64)
        vs = []
        for k in range(d):
            b = np.zeros(d - 1)
            if k:
                b[k - 1] = 1.0
            rhs = np.concatenate([[-float(a["tri_dc"][i])], en_p1 - b])
            vs.append(np.linalg.solve(m, rhs))
        out.append(vs)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("d", [9, 10, 12, 16])
def test_grid_nearest_kernel_corner_cases(cuda, d):
    """Kernel 2.9 on ``_grid_corner_cases(d)`` -- ties across lanes and
    tiles, the winner skipped, NaN origins, a dead block, a live block
    without hits, hits only in the second tile -- with the shared rows and
    without: t, ids and tiles equal the twin's bit for bit."""
    kern, oT, dT, skip, sh, facts = _grid_corner_cases(d, cuda)
    print(f"d = {d}: {facts}")
    assert facts["copies"] == 600 and facts["copy_tiles"] == 2
    assert facts["tied_winner"] and facts["skipped_winner"]
    assert facts["nan_hits"] == 0 and facts["dead_tiles"] == 0
    assert facts["live_no_hit"] and facts["second_tile"]
    for kw in (dict(sh=sh), {}):
        n0 = gk.nearest_hit.launches
        got = gk.nearest_hit(kern, oT, dT, skip, d, **kw)
        assert gk.nearest_hit.launches == n0 + 1
        torch.cuda.synchronize()
        _grid_equal(got, gk.nearest_hit_ref(kern, oT, dT, skip, d, **kw))


def _grid_occlusion_cases(d, dev):
    """Kernel 2.10's corner cases at dimension ``d`` over the pool of
    ``_grid_corner_cases(d)`` (the tie copies fill lanes 300.. of the first
    tile and the second tile), seven 512-ray blocks of shadow rays from its
    camera, ldist from the twin's nearest hit t:
      0. aimed at the copies, ldist just above t on even rays (blocked),
         ldist = t on odd rays (an occluder at t = ldist: not blocked);
      1. the same, each skipping the winning copy's id: the next copy
         blocks;
      2. the same with every other origin NaN;
      3. pointing away from the pool with ldist 0: a dead block;
      4. aimed at the copies with ldist 0, -1, NaN and inf by turns;
      5. aimed at simplices of the second tile (no valid pair in the
         first), ldist just above the hit, even rays skipping what they hit
         (the first tile runs where the block's rays enter its box before
         their ldist);
      6. aimed at the copies with ldist inf: every ray blocked at lane 300
         of the first tile, so whole warps end blocked inside it.
    Returns (kern, oT, dT, ldist, skip, facts), facts the twin's view."""
    kern, oT, dT, skip, _sh, _facts = _grid_corner_cases(d, dev)
    t, ids, _tiles = gk.nearest_hit_ref(kern, oT, dT, skip, d)
    t, ids = t.reshape(6, 512), ids.reshape(6, 512)
    blk = [slice(i * 512, (i + 1) * 512) for i in range(6)]
    above = torch.nextafter(t, torch.full_like(t, float("inf")))
    even = torch.arange(512, device=dev) % 2 == 0
    none = torch.full((512,), -1, dtype=torch.int32, device=dev)
    mix = torch.tensor([0.0, -1.0, float("nan"), float("inf")],
                       device=dev)[torch.arange(512, device=dev) % 4]
    inf = torch.full((512,), float("inf"), device=dev)
    rows = [
        (oT[:, blk[0]], dT[:, blk[0]], torch.where(even, above[0], t[0]),
         none),
        (oT[:, blk[1]], dT[:, blk[1]], above[1], skip[blk[1]]),
        (oT[:, blk[2]], dT[:, blk[2]], above[0], none),
        (oT[:, blk[3]], dT[:, blk[3]], torch.zeros_like(inf), none),
        (oT[:, blk[0]], dT[:, blk[0]], mix, none),
        (oT[:, blk[5]], dT[:, blk[5]], above[5],
         torch.where(even, ids[5], -1).to(torch.int32)),
        (oT[:, blk[0]], dT[:, blk[0]], inf, none),
    ]
    o, dv, ld, sk = (torch.cat(x, dim=-1).contiguous() for x in zip(*rows))
    blocked, tiles = gk.occluded_ref(kern, o, dv, ld, sk, d)
    b = blocked.reshape(7, 512)
    facts = dict(
        just_below=bool(b[0, ::2].all()), at_ldist=not bool(b[0, 1::2].any()),
        skipped=bool(b[1].all()),
        nan=not bool(b[2, ::2].any()) and bool(b[2, 1::2].all()),
        dead_tiles=int(tiles[3]),
        ldist_mix=bool(torch.equal(b[4], torch.isinf(mix))),
        second_tile=bool(b[5, 1::2].all()) and not bool(b[5, ::2].any())
        and int(tiles[5]) >= 1 and bool((ids[5] >= gk.TRI_BLOCK).all()),
        mid_tile=bool(b[6].all()) and int(tiles[6]) == 1)
    return kern, o, dv, ld, sk, facts


@pytest.mark.parametrize("d", [9, 10, 12, 16])
def test_grid_occluded_kernel_corner_cases(cuda, d):
    """Kernel 2.10 on ``_grid_occlusion_cases(d)`` -- an occluder just below
    ldist and one at ldist, the skipped id, NaN origins, a dead block,
    ldist <= 0, NaN and inf, an occluder only in the second tile, warps
    that end blocked inside a tile -- reading the plane records the device
    scene carries and ones the wrapper makes: ``blocked`` and tiles equal
    the twin's."""
    kern, oT, dT, ld, sk, facts = _grid_occlusion_cases(d, cuda)
    print(f"d = {d}: {facts}")
    assert all(v for k, v in facts.items() if k != "dead_tiles")
    assert facts["dead_tiles"] == 0
    ref = gk.occluded_ref(kern, oT, dT, ld, sk, d)
    bare = {k: v for k, v in kern.items() if k != "grec"}
    for k in (kern, bare):
        n0 = gk.occluded.launches
        got = gk.occluded(k, oT, dT, ld, sk, d)
        assert gk.occluded.launches == n0 + 1
        torch.cuda.synchronize()
        _grid_equal(got, ref)


def test_grid_occluded_kernel_launch_info(cuda):
    """Kernel 2.10 as it launches at d = 9, 10 and 16: one ray a thread, a
    ring of at least two slots, at least one block an SM, no spill."""
    for d in (9, 10, 16):
        info = gk.launch_info(d, walk="occluded")
        print(f"2.10 d = {d}: {info}")
        assert info["rays_per_thread"] == 1
        assert info["ring_slots"] >= 2 and info["blocks_per_sm"] >= 1
        assert info["registers"] <= 255


def test_grid_nearest_kernel_launch_info(cuda):
    """Kernel 2.9 as it launches at d = 9, 10 and 16 (both variants): two
    rays a thread with the shared rows, one without, a ring of at least two
    slots, at least one block an SM."""
    for d in (9, 10, 16):
        for shared in (True, False):
            info = gk.launch_info(d, shared)
            print(f"2.9 d = {d} shared={shared}: {info}")
            assert info["rays_per_thread"] == (2 if shared else 1)
            assert info["ring_slots"] >= 2 and info["blocks_per_sm"] >= 1
            assert info["registers"] <= 255


def test_card_callback_frames_equal_blocking_frames(cuda):
    """CallbackRenderer on the card: three frames in flight, the camera
    moved after each dispatch; each buffer holds BlockingRenderer's bytes
    for its camera (the pull's copy stream waits for its own frame, not for
    the frames dispatched after it), in FIFO order."""
    import threading
    from ntracer_tpu_torch import CallbackRenderer
    nt = api().NTracer(4)
    scene = polytope_scene()
    cam = scene.get_camera()
    fmt = rgb8(W, H)

    def advance():
        c = scene.get_camera()
        c.transform(nt.Matrix.rotation(c.axes[0], c.axes[2], 0.3))
        c.normalize()
        scene.set_camera(c)

    blocking = []
    for _ in range(3):
        buf = bytearray(fmt.pitch * H)
        assert BlockingRenderer().render(buf, fmt, scene)
        blocking.append(bytes(buf))
        advance()
    scene.set_camera(cam)
    cr = CallbackRenderer()
    bufs = [bytearray(fmt.pitch * H) for _ in range(3)]
    order = []
    done = threading.Event()

    def callback(k):
        def cb(_r):
            order.append(k)
            if len(order) == 3:
                done.set()
        return cb

    for k in range(3):
        cr.begin_render(bufs[k], fmt, scene, callback(k))
        advance()
    assert done.wait(timeout=120)
    assert order == [0, 1, 2]
    assert [bytes(b) for b in bufs] == blocking


def test_card_wide_channel_frame_equals_cpu_bytes(cuda):
    """A 30/30/4 frame on the card: float colors from the device, packed on
    the host; its bytes equal the exact packer's of the card's colors, and
    the CPU's bytes (the card's colors equal the CPU's)."""
    a = api()
    fmt = a.ImageFormat(W, H, [a.Channel(30, 1, 0, 0), a.Channel(30, 0, 1, 0),
                               a.Channel(4, 0, 0, 1)])
    scene = lit_scene_3d()
    card = bytearray(fmt.pitch * H)
    assert BlockingRenderer().render(card, fmt, scene)
    colors = pwf.frame_colors(scene, W, H, cuda)
    assert bytes(card) == pwf.packing.pack_rows(colors, fmt).tobytes()
    cpu = bytearray(fmt.pitch * H)
    assert BlockingRenderer(device="cpu").render(cpu, fmt, scene)
    np.testing.assert_allclose(colors, pwf.frame_colors(scene, W, H, "cpu"),
                               rtol=2e-6, atol=2e-7)
    assert card == cpu
