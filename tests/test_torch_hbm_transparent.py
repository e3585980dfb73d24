"""The port's streaming K-slot walk and filtered occlusion walk (kernels
2.7 and 2.8) vs the JAX package's ``nearest_hit_transparent_hbm`` and
``occluded_transparent_hbm`` (interpret mode), on scenes of glass over the
line; the contract and the inputs are tests/test_torch_hbm.py's.  Also: the
streaming K-slot walk's grouped schedule against the resident walk's one
candidate a step."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntracer_tpu.engine import resident_kernels as jrk
from ntracer_tpu_torch.engine import wavefront as pwf
from ntracer_tpu_torch.engine import resident_kernels as prk

from _torch_helpers import JAX, glass_scene
from test_torch_resident import _t_rounding_bound
from test_torch_hbm import (N, W, H, _t, _case, _block_mask, _walk_inputs,
                            _shadow_inputs, _wrappers_take_the_twins,
                            _equal_at_two_step_sizes)

GLASS = {
    "3d_mixed_600": lambda: glass_scene(600, pkg=JAX),
    "3d_all_glass": lambda: glass_scene(500, seed=3, spread=0.7,
                                        all_glass=True, pkg=JAX),
}


@pytest.fixture(scope="module", params=sorted(GLASS))
def glass(request):
    return _case(request.param, GLASS[request.param])


@pytest.mark.parametrize("K", [8, 2])
@pytest.mark.parametrize("mode", ["primary", "bounce"])
def test_nearest_hit_transparent_hbm_ref_matches_pallas(glass, mode, K):
    d = glass["cfg"].d
    o, dirs, skip, jkw, pkw = _walk_inputs(glass, mode)
    jt, jgid, jtt, jtgid, jvis = jrk.nearest_hit_transparent_hbm(
        glass["jres"], jnp.asarray(o), jnp.asarray(dirs), jnp.asarray(skip),
        d, K, **jkw)
    jt, jgid, jvis = np.asarray(jt), np.asarray(jgid), np.asarray(jvis)
    jtt, jtgid = np.asarray(jtt).T, np.asarray(jtgid).T          # (K, R)
    pt, pslot, ptt, ptslot, pvis = prk.nearest_hit_transparent_hbm_ref(
        glass["pres"], _t(o.T), _t(dirs.T), _t(skip), d, K, **pkw)
    pt, pslot, ptt, ptslot = (x.numpy() for x in (pt, pslot, ptt, ptslot))
    assert ptt.shape == (K, N) and ptslot.dtype == np.int32
    slot_ids = glass["arrs"]["res_ids"][:, 0, :].reshape(-1)
    pgid = np.where(pslot >= 0, slot_ids[np.clip(pslot, 0, None)], -1)
    ptgid = np.where(ptslot >= 0, slot_ids[np.clip(ptslot, 0, None)], -1)
    assert np.array_equal(pgid, jgid)
    assert np.array_equal(ptgid, jtgid), \
        f"{int((ptgid != jtgid).sum())} slot entries differ"
    assert np.array_equal(pvis.numpy(), jvis)
    hits = jgid >= 0
    bound = _t_rounding_bound(o, dirs, pslot, glass["arrs"], d)
    assert (np.abs(pt - jt) <= 1e-6 * np.abs(jt) + bound)[hits].all()
    assert np.array_equal(pt[~hits], jt[~hits])
    filled = ptslot >= 0
    assert np.array_equal(np.isinf(ptt), ~filled)
    for k in range(K):
        m = filled[k]
        bk = _t_rounding_bound(o, dirs, ptslot[k], glass["arrs"], d)
        assert (np.abs(ptt[k] - jtt[k])
                <= 1e-6 * np.abs(jtt[k]) + bk)[m].all()
    print(f"{glass['name']} {mode} K={K}: {int(hits.sum())} opaque hits, "
          f"{int(filled.sum())} slots filled, "
          f"{int(filled.all(axis=0).sum())} rays filled all {K}")
    assert filled.sum() > (100 if mode == "primary" else 20)
    if mode == "bounce":
        assert (pvis.numpy()[1::2] == 0).all()
        assert not filled[:, ~_block_mask()].any()


@pytest.mark.parametrize("light", ["point", "global"])
def test_occluded_transparent_hbm_ref_matches_pallas(glass, light):
    d = glass["cfg"].d
    point, dirs, ldist, skip, live = _shadow_inputs(glass, light)
    pb, pf, pv = prk.occluded_transparent_hbm_ref(
        glass["pres"], _t(point.T), _t(dirs.T), _t(ldist), _t(skip), d)
    pb, pf, pv = pb.numpy(), pf.numpy(), pv.numpy()
    jb, jf, jv = jrk.occluded_transparent_hbm(
        glass["jres"], jnp.asarray(point), jnp.asarray(dirs),
        jnp.asarray(ldist), jnp.asarray(skip), d)
    jb, jf, jv = np.asarray(jb), np.asarray(jf), np.asarray(jv)
    assert np.array_equal(pb, jb)
    assert np.array_equal(pf[~pb].view(np.int32), jf[~pb].view(np.int32))
    assert np.array_equal(pv, jv)
    assert (pf[pb] == 1).all() and (pf[~live] == 1).all()
    assert not pb[~live].any()
    print(f"{glass['name']} {light}: {int(live.sum())} live, "
          f"{int(pb.sum())} blocked, {int(((pf < 1) & ~pb).sum())} filtered")
    assert ((pf < 1) & ~pb).sum() > 20
    if glass["name"] == "3d_all_glass":
        assert not pb.any()
    else:
        assert pb[live].any() and not pb[live].all()


def _narrow_glass():
    """Glass and opaque by turns, 3,000 triangles (24 chunks), seen through
    a 0.1 rad field of view: each 512-ray block covers a small solid angle,
    so its nearest opaque hits, and with them its bound, drop within a
    group of visits."""
    scene = glass_scene(3000, seed=31, spread=0.4)
    scene.set_fov(0.1)
    return scene


def test_grouped_schedule_differs_from_one_a_step():
    """The streaming K-slot walk (kernel 2.7) picks four candidates a step
    with the bound from before the previous group, the resident one
    (kernel 2.3) one a step: the same nearest opaque hit, but a stale bound
    visits more chunks, and their far glass hits take slots.  So slot
    positions (or visits) differ on some rays, which is why each walk has
    its own twin.  (On an all-glass scene no opaque hit lowers the bound,
    both walks visit every chunk the block enters, and nothing differs.)"""
    scene = _narrow_glass()
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    scene._set_view_size(W, H)
    fov = pwf._fov_params(W, H, scene.fov)
    xs, ys, _ = pwf._ray_coords(0, W, N, "cpu")
    cam_o = _t(np.asarray(scene._cam._origin, np.float32))
    oT, dT = pwf.make_rays(cam_o, _t(np.asarray(scene._cam._t, np.float32)),
                           *fov, xs, ys)
    pctx = pwf.primary_ctx(arrs, cfg, cam_o)
    args = (pwf._res_dict(arrs), oT, dT,
            torch.full((N,), -1, dtype=torch.int32), cfg.d, 8)
    kw = dict(order=pctx["order"], sh=pctx["sh_res"])
    one = prk.nearest_hit_transparent_ref(*args, **kw)
    grouped = prk.nearest_hit_transparent_hbm_ref(*args, **kw)
    assert torch.equal(one[0], grouped[0]) and torch.equal(one[1], grouped[1])
    moved = (one[3] != grouped[3]).any(dim=0)
    print(f"{int(moved.sum())} rays' slots differ; visits "
          f"{one[4].tolist()} vs {grouped[4].tolist()}")
    assert int(moved.sum()) > 0
    assert (grouped[4] >= one[4]).all() and (grouped[4] > one[4]).any()
    # the wrappers on CPU tensors take these twins
    assert all(torch.equal(a, b) for a, b in zip(
        prk.nearest_hit_transparent_hbm(*args, **kw), grouped))


def test_streaming_wrappers_take_the_twins_on_cpu(glass):
    _wrappers_take_the_twins(glass)


def test_twin_walks_equal_at_two_step_sizes(glass, monkeypatch):
    _equal_at_two_step_sizes(glass, monkeypatch)
