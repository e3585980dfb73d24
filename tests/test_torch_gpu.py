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
from ntracer_tpu_torch.engine import resident_kernels as prk

from _torch_helpers import (random_scene, polytope_scene, reflective_scene,
                            lit_scene, lit_scene_3d, glass_scene, rgb8)

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
