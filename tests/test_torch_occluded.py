"""The port's occlusion walk vs the JAX package.

The JAX side runs the Pallas kernel in interpret mode (the device scene is
built under NTRACER_FORCE_KERNELS).  Both engines get the same shadow rays
(numpy arrays: the hit points of a primary trace, a light direction, a
distance per ray, the id of the surface each ray leaves), so differences can
only come from the walk itself.  ``blocked`` is a monotone OR of exact
per-ray tests, so whichever chunks a walk visits beyond the necessary ones,
it must be equal on every ray, at any candidate grouping; the twin mirrors
the default grouping (4), so its visit counts equal the kernel's there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu.engine import resident_kernels as jrk
from ntracer_tpu_torch.engine import wavefront as pwf
from ntracer_tpu_torch.engine import resident_kernels as prk

from _torch_helpers import (JAX, random_scene, polytope_scene, lit_scene,
                            jax_device_scene)

W = H = 128
N = W * H             # the whole frame: 32 walk blocks
REAL_MAX = np.float32(np.finfo(np.float32).max)

SCENES = {
    "3d_1200": lambda: random_scene(3, n=1200, seed=7, pkg=JAX),
    "4d_600cell": lambda: polytope_scene(pkg=JAX),
    "6d_lit_200": lambda: lit_scene(6, n=200, pkg=JAX),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    """A scene's JAX device scene, and shadow rays leaving the hit points of
    its primary wavefront (the frame's first rays, in tile order)."""
    mp = pytest.MonkeyPatch()
    scene = SCENES[request.param]()
    cfg, arrs, _flat = jax_device_scene(scene, mp)
    mp.undo()
    d = cfg.d
    tens = pwf.tensors_from_arrays(arrs, "cpu")
    pcfg = pwf.SceneConfig(**{k: v for k, v in vars(cfg).items()
                              if k != "prim_axis"})
    scene._set_view_size(W, H)
    fov = pwf._fov_params(W, H, scene.fov)
    xs, ys, _ = pwf._ray_coords(0, W, N, "cpu")
    cam_o = _t(np.asarray(scene._cam._origin, np.float32))
    cam_t = _t(np.asarray(scene._cam._t, np.float32))
    oT, dT = pwf.make_rays(cam_o, cam_t, *fov, xs, ys)
    hit = pwf.trace_pool(tens, pcfg, oT, dT,
                         torch.full((N,), -1, dtype=torch.int32),
                         shared_origin=cam_o)
    m = hit["hit"].numpy()
    print(f"{request.param}: {int(m.sum())} of {N} rays hit")
    assert m.sum() > 300
    # misses (t = REAL_MAX) get the origin: finite, and never active
    point = np.where(m[:, None], hit["pointT"].numpy().T, 0) \
        .astype(np.float32)                                 # (N, d)
    # every other block is dead, and so are the misses
    live = m & (np.arange(N) // prk.RAY_BLOCK % 2 == 0)

    # a point light: finite distances
    pos = np.zeros(d, np.float32)
    pos[0], pos[1], pos[2] = -1, 2, -3
    lv = point - pos
    dist = np.sqrt((lv * lv).sum(axis=1)).astype(np.float32)
    lv = (lv / dist[:, None]).astype(np.float32)
    # a global light: REAL_MAX, cut to the ray's exit from the pool's box
    gdir = np.zeros(d, np.float32)
    gdir[1], gdir[2] = 1, 0.25
    gdir = np.tile(gdir / np.linalg.norm(gdir), (N, 1)).astype(np.float32)
    exit_t = prk._scene_exit_T(_t(point.T), _t(gdir.T), tens["res_blo"],
                               tens["res_bhi"]).numpy()
    rays = {
        "point": (lv, np.where(live, dist, 0).astype(np.float32), False),
        "global": (gdir, np.where(live, REAL_MAX, 0).astype(np.float32),
                   True),
    }
    return dict(cfg=cfg, pcfg=pcfg, arrs=arrs, tens=tens,
                jdev=jwf.get_device_scene(scene)[1], point=point,
                skip=hit["pid"].numpy(), live=live, rays=rays,
                exit_t=exit_t)


@pytest.mark.parametrize("light", ["point", "global"])
def test_occluded_ref_matches_pallas(case, light):
    d = case["cfg"].d
    dirs, ldist, clamp = case["rays"][light]
    if clamp:
        ldist = np.minimum(ldist, case["exit_t"])
    point, skip = case["point"], case["skip"]
    pres = pwf._res_dict(case["tens"])
    blocked, vis = prk.occluded_ref(pres, _t(point.T), _t(dirs.T), _t(ldist),
                                    _t(skip), d)
    blocked, vis = blocked.numpy(), vis.numpy()
    assert blocked.dtype == np.bool_ and vis.dtype == np.int32
    jres = jwf._res_dict(case["jdev"])
    for cand in (1, 4):
        jb, jv = jrk.occluded(jres, jnp.asarray(point), jnp.asarray(dirs),
                              jnp.asarray(ldist), jnp.asarray(skip), d,
                              cand=cand)
        jb, jv = np.asarray(jb), np.asarray(jv)
        assert jb.shape == blocked.shape and jv.shape == vis.shape
        # equal on every ray, whatever the grouping
        assert np.array_equal(blocked, jb), \
            f"cand={cand}: {int((blocked != jb).sum())} rays differ"
        if cand == 4:
            assert np.array_equal(vis, jv)
        else:
            assert (vis >= jv).all()
    live = case["live"]
    assert blocked[live].any() and not blocked[live].all()
    assert not blocked[~live].any()
    assert (vis[1::2] == 0).all() and vis[0::2].any()


@pytest.mark.parametrize("light", ["point", "global"])
def test_occlusion_matches_jax(case, light):
    """``wavefront.occlusion`` of both packages on the same inputs: the
    exit clamp of the global light included."""
    dirs, ldist, clamp = case["rays"][light]
    point, skip = case["point"], case["skip"]
    jb, _filt = jwf.occlusion(case["jdev"], case["cfg"], jnp.asarray(point),
                              jnp.asarray(dirs), jnp.asarray(ldist),
                              jnp.asarray(skip), clamp_exit=clamp)
    pb, pf = pwf.occlusion(case["tens"], case["pcfg"], _t(point.T),
                           _t(dirs.T), _t(ldist), _t(skip), clamp_exit=clamp)
    assert pb.dtype == torch.bool
    # nothing filters in an opaque scene: the JAX package says so with
    # ones, the port with None
    assert pf is None and (np.asarray(_filt) == 1).all()
    assert np.array_equal(pb.numpy(), np.asarray(jb))
    assert pb.numpy()[case["live"]].any()


def test_wrapper_takes_the_twin_on_cpu(case):
    d = case["cfg"].d
    dirs, ldist, _ = case["rays"]["point"]
    args = (pwf._res_dict(case["tens"]), _t(case["point"].T), _t(dirs.T),
            _t(ldist), _t(case["skip"]), d)
    before = prk.occluded.launches
    got = prk.occluded(*args)
    ref = prk.occluded_ref(*args)
    assert prk.occluded.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_visit_order_does_not_change_blocked(case):
    """A reversed chunk order visits other chunks first and may visit more
    of them; ``blocked`` is the same."""
    d = case["cfg"].d
    dirs, ldist, _ = case["rays"]["point"]
    res = pwf._res_dict(case["tens"])
    args = (res, _t(case["point"].T), _t(dirs.T), _t(ldist),
            _t(case["skip"]), d)
    ref, _ = prk.occluded_ref(*args)
    rev = torch.flip(res["base_order"], dims=[0]).contiguous()
    got, _ = prk.occluded_ref(*args, order=rev)
    assert torch.equal(got, ref)


def test_dead_wavefront_and_skip_ids():
    """A wavefront without an active ray is all unblocked with no visit; a
    ray never hits the surface it leaves, and without the skip id it
    would."""
    scene = random_scene(3, n=300, seed=2)
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    res = pwf._res_dict(arrs)
    R = 2 * prk.RAY_BLOCK
    scene._set_view_size(32, 32)
    xs, ys, _ = pwf._ray_coords(0, 32, R, "cpu")
    cam_o = _t(np.asarray(scene._cam._origin, np.float32))
    cam_t = _t(np.asarray(scene._cam._t, np.float32))
    oT, dT = pwf.make_rays(cam_o, cam_t, *pwf._fov_params(32, 32, scene.fov),
                           xs, ys)
    hit = pwf.trace_pool(arrs, cfg, oT, dT,
                         torch.full((R,), -1, dtype=torch.int32),
                         shared_origin=cam_o)
    blocked, vis = prk.occluded(res, hit["pointT"], dT, torch.zeros(R),
                                hit["pid"], cfg.d)
    assert not blocked.any() and not vis.any()
    # back along the primary ray, from the camera towards the hit point and
    # a little beyond: only the hit surface itself is in range
    m = hit["hit"]
    assert int(m.sum()) > 50
    ld = torch.where(m, hit["t"] * 1.0001, 0.0)
    with_skip, _ = prk.occluded(res, oT, dT, ld, hit["pid"], cfg.d)
    without, _ = prk.occluded(res, oT, dT, ld,
                              torch.full((R,), -1, dtype=torch.int32), cfg.d)
    assert without[m].all() and not without[~m].any()
    assert int(with_skip.sum()) < int(without.sum())
    with pytest.raises(ValueError, match="multiple of 512"):
        prk.occluded(res, oT[:, :100].contiguous(), dT[:, :100].contiguous(),
                     ld[:100], hit["pid"][:100], cfg.d)
