"""The port's nearest-hit walk and its per-frame prep vs the JAX package.

The JAX side runs the Pallas kernel in interpret mode (the device scene is
built under NTRACER_FORCE_KERNELS).  Both engines get the same rays, the
same layouts and the same per-frame rows, so differences can only come from
the walk itself: the winning slot must agree on every ray.  t is compared
to rtol 1e-6 plus the rounding bound of its numerator, because XLA on the
CPU contracts a*b+c into FMAs inside the interpreted kernel while the twin
rounds every operation: where a bounce ray's origin dot cancels against the
plane offset, the two roundings differ by more than 1e-6 relative.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu.engine import resident_kernels as jrk
from ntracer_tpu_torch.engine import wavefront as pwf
from ntracer_tpu_torch.engine import resident_kernels as prk

from _torch_helpers import (JAX, random_scene, polytope_scene,
                            jax_device_scene)

W = H = 64
N = jwf.TILE          # one dispatch group: 64 walk blocks


@pytest.fixture(scope="module", params=["3d_random", "4d_600cell"])
def case(request):
    """A scene, its JAX device scene and primary ray wavefront (the frame's
    first dispatch group, in tile order), as both engines' inputs."""
    mp = pytest.MonkeyPatch()
    scene = (random_scene(3, n=1200, seed=7, pkg=JAX)
             if request.param == "3d_random" else polytope_scene(pkg=JAX))
    cfg, arrs, _flat = jax_device_scene(scene, mp)
    mp.undo()
    scene._set_view_size(W, H)
    fov = jwf._fov_params(W, H, scene.fov)
    xs, ys, _ = jwf._ray_coords(0, W, N)
    origin = np.asarray(scene._cam._origin, np.float32)
    o, dirs = jwf.make_rays(jnp.asarray(origin), jnp.asarray(scene._cam._t),
                            *fov, xs, ys)
    dev = jwf.get_device_scene(scene)[1]
    pctx = jwf.primary_ctx(dev, cfg, jnp.asarray(origin))
    return dict(scene=scene, cfg=cfg, arrs=arrs, jres=jwf._res_dict(dev),
                pctx={k: np.asarray(v) for k, v in pctx.items()},
                o=np.asarray(o), dirs=np.asarray(dirs), origin=origin,
                tens=pwf.tensors_from_arrays(arrs, "cpu"))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_chunk_order_matches_jax(case):
    res = case["tens"]
    order, dmin = prk.chunk_order(res["res_klo"], res["res_khi"],
                                  _t(case["origin"]))
    assert order.dtype == torch.int32
    assert np.array_equal(order.numpy(), case["pctx"]["order"])
    assert np.array_equal(dmin.numpy(), case["pctx"]["dmin"])


def test_chunk_order_ties_keep_pool_order():
    """An origin inside several boxes gives them distance 0: the stable
    sort keeps them in pool order, as jnp.argsort does."""
    klo = torch.tensor([[0., 0.], [5., 5.], [-1., -1.], [-2., -2.]])
    khi = torch.tensor([[2., 2.], [6., 6.], [3., 3.], [4., 4.]])
    order, dmin = prk.chunk_order(klo, khi, torch.tensor([1., 1.]))
    ref_order, ref_dmin = jrk.chunk_order(jnp.asarray(klo.numpy()),
                                          jnp.asarray(khi.numpy()),
                                          jnp.asarray([1., 1.], jnp.float32))
    assert order.tolist() == [0, 2, 3, 1] == np.asarray(ref_order).tolist()
    assert np.array_equal(dmin.numpy(), np.asarray(ref_dmin))


def test_shared_rows_res_matches_jax(case):
    res = case["tens"]
    sh = prk.shared_rows_res(res["res_gt"], res["res_ci"],
                             _t(case["origin"]), case["cfg"].d)
    assert np.array_equal(sh.numpy(), case["pctx"]["sh_res"])


def test_scene_exit_T_matches_jax(case):
    arrs = case["arrs"]
    ref = jrk._scene_exit_T(jnp.asarray(case["o"].T),
                            jnp.asarray(case["dirs"].T),
                            jnp.asarray(arrs["res_blo"]),
                            jnp.asarray(arrs["res_bhi"]))
    got = prk._scene_exit_T(_t(case["o"].T), _t(case["dirs"].T),
                            _t(arrs["res_blo"]), _t(arrs["res_bhi"]))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert (got > 0).any() and (got == 0).any()


def _bounce_inputs(case):
    """A bounce-mode wavefront: seeded origins inside the pool's box and
    seeded directions, every other block inactive, and half the rays
    skipping the pool id they would hit first (so they must find the next
    surface)."""
    rng = np.random.RandomState(11)
    d = case["cfg"].d
    lo, hi = case["arrs"]["res_blo"], case["arrs"]["res_bhi"]
    o = (lo + (hi - lo) * rng.uniform(0.25, 0.75, (N, d))).astype(np.float32)
    dirs = rng.normal(size=(N, d))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)) \
        .astype(np.float32)
    _t0, slot0, _ = jrk.nearest_hit(case["jres"], jnp.asarray(o),
                                    jnp.asarray(dirs),
                                    jnp.full((N,), -1, jnp.int32), d,
                                    raw_slot=True)
    slot0 = np.asarray(slot0)
    gid = case["arrs"]["res_slot_pack"][np.clip(slot0, 0, None), d + 1]
    skip = np.where((slot0 >= 0) & (np.arange(N) % 2 == 0), gid, -1) \
        .astype(np.int32)
    active = np.arange(N) // jrk.RAY_BLOCK % 2 == 0
    return o, dirs, skip, active


def _t_rounding_bound(o, dirs, slot, arrs, d):
    """Per-ray bound on the rounding error of the winning pair's
    t = (ci0 - o.n) / (d.n), summed over both engines' evaluations."""
    eps = float(np.finfo(np.float32).eps)
    s = np.clip(slot, 0, None)
    g = arrs["res_gt"][s // 128, :d, s % 128].astype(np.float64)   # (R, d)
    ci0 = arrs["res_ci"][s // 128, 0, s % 128].astype(np.float64)
    on = np.abs(o * g).sum(axis=1)
    dn = np.abs(dirs * g).sum(axis=1)
    denom = np.abs((dirs * g).sum(axis=1))
    t = np.abs((ci0 - (o * g).sum(axis=1)) / denom)
    return 4 * (d + 2) * eps * ((np.abs(ci0) + on) / denom + t * dn / denom)


@pytest.mark.parametrize("mode", ["primary", "bounce"])
def test_nearest_hit_ref_matches_pallas(case, mode):
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
    jt, jslot, jvis = jrk.nearest_hit(case["jres"], jnp.asarray(o),
                                      jnp.asarray(dirs), jnp.asarray(skip),
                                      d, raw_slot=True, **jkw)
    jt, jslot = np.asarray(jt), np.asarray(jslot)
    res = pwf._res_dict(case["tens"])
    pt, pslot, pvis = prk.nearest_hit_ref(res, _t(o.T), _t(dirs.T),
                                          _t(skip), d, **pkw)
    pt, pslot = pt.numpy(), pslot.numpy()
    hits = jslot >= 0
    assert hits.sum() > (100 if mode == "primary" else 20)
    assert np.array_equal(pslot, jslot)
    bound = _t_rounding_bound(o, dirs, jslot, case["arrs"], d)
    assert (np.abs(pt - jt) <= 1e-6 * np.abs(jt) + bound)[hits].all()
    # rays without a hit keep their start distance: exactly the same
    assert np.array_equal(pt[~hits], jt[~hits])
    # visit counts may differ by design; both skip dead blocks
    assert pvis.shape == np.asarray(jvis).shape
    if mode == "bounce":
        assert (pvis.numpy()[1::2] == 0).all()


def test_wrapper_takes_the_twin_on_cpu(case):
    res = pwf._res_dict(case["tens"])
    args = (res, _t(case["o"].T), _t(case["dirs"].T),
            torch.full((N,), -1, dtype=torch.int32), case["cfg"].d)
    kw = dict(order=_t(case["pctx"]["order"]), sh=_t(case["pctx"]["sh_res"]))
    before = prk.nearest_hit.launches
    got = prk.nearest_hit(*args, **kw)
    ref = prk.nearest_hit_ref(*args, **kw)
    assert prk.nearest_hit.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_walk_rejects_a_partial_block():
    scene = random_scene(3, n=50, seed=2)
    _cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    o = torch.zeros((3, 100))
    with pytest.raises(ValueError, match="multiple of 512"):
        prk.nearest_hit(pwf._res_dict(arrs), o, o, torch.zeros(100,
                        dtype=torch.int32), 3)


def test_sqrt_is_correctly_rounded():
    """The port's float32 square root equals numpy's (IEEE, correctly
    rounded) bit for bit, including values where torch's own CPU sqrt is
    one ulp off."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.uniform(0, 10, 200000),
                        np.exp(rng.uniform(-80, 80, 200000)),
                        [0, -0.0, 1, 4, np.inf, 1e-45, 3.4e38]]) \
        .astype(np.float32)
    got = prk._sqrt(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))
    assert (torch.sqrt(torch.from_numpy(x)).numpy() != got).any()
