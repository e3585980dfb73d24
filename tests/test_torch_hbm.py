"""The port's walks over the line (kernels 2.5 and 2.6 here, 2.7 and 2.8
in tests/test_torch_hbm_transparent.py) vs the JAX package's.

Pools over the line (the JAX package's ``POOL_VMEM_BUDGET``, the port's
``STREAM_POOL_BYTES``; both monkeypatched to 1 KiB here, as
tests/test_pallas.py does) take the JAX package's streaming kernels.  The
JAX side runs its Pallas kernels ``nearest_hit_hbm``, ``occluded_hbm``,
``nearest_hit_transparent_hbm`` and ``occluded_transparent_hbm`` in
interpret mode (the device scene is built under NTRACER_FORCE_KERNELS);
the port's side is the twin of the walk that stands for each
(``nearest_hit_ref``, ``occluded_ref``, ``nearest_hit_transparent_hbm_ref``,
``occluded_transparent_ref``: one walk serves a pool of any size, and only
the K-slot walk changes its rule at the line), which its CUDA kernel
equals bit for bit on the card (tests/test_torch_gpu.py, chip_smoke.py).
Both get the same rays, layouts and opacity row.

Contract held here, on 4,096-ray wavefronts: slots and ids exact, the K
slots position by position (the streaming K-slot walk picks candidates in
groups of four, as the TPU kernel does, and slot positions follow from the
visit set), visits equal; t and tt within rtol 1e-6 plus the rounding bound
of the pair test's numerator (XLA on the CPU contracts a*b+c into FMAs in
the interpreted kernel; the twin rounds every operation); ``blocked``
exact, ``filt`` bit-equal on unblocked rays (the port sets it to 1 on
blocked ones).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu.engine import resident_kernels as jrk
from ntracer_tpu_torch.engine import wavefront as pwf
from ntracer_tpu_torch.engine import resident_kernels as prk

from _torch_helpers import (JAX, polytope_scene, mirror_scene_1500,
                            jax_device_scene)
from test_torch_resident import _t_rounding_bound

W = H = 64
N = W * H             # the whole frame: 8 walk blocks
REAL_MAX = float(np.finfo(np.float32).max)

OPAQUE = {
    "3d_mirror_1500": lambda: mirror_scene_1500(pkg=JAX),
    "4d_600cell": lambda: polytope_scene(pkg=JAX),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(name, make):
    """A scene over the line, its JAX device scene and the frame's primary
    wavefront (tile order) as both engines' inputs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jrk, "POOL_VMEM_BUDGET", 1024)
    scene = make()
    cfg, arrs, _flat = jax_device_scene(scene, mp)
    dev = jwf.get_device_scene(scene)[1]
    mp.undo()
    assert "res_is_hbm" in arrs
    scene._set_view_size(W, H)
    fov = jwf._fov_params(W, H, scene.fov)
    xs, ys, _ = jwf._ray_coords(0, W, N)
    origin = np.asarray(scene._cam._origin, np.float32)
    o, dirs = jwf.make_rays(jnp.asarray(origin), jnp.asarray(scene._cam._t),
                            *fov, xs, ys)
    pctx = jwf.primary_ctx(dev, cfg, jnp.asarray(origin))
    jres = jwf._res_dict(dev)
    if cfg.has_transparency:
        jres["opa"] = dev["res_opa"]
    tens = pwf.tensors_from_arrays(arrs, "cpu")
    assert "res_is_hbm" in tens
    return dict(name=name, cfg=cfg, arrs=arrs, jres=jres,
                pctx={k: np.asarray(v) for k, v in pctx.items()},
                o=np.asarray(o), dirs=np.asarray(dirs), tens=tens,
                pres=pwf._res_dict(tens))


@pytest.fixture(scope="module", params=sorted(OPAQUE))
def opaque(request):
    return _case(request.param, OPAQUE[request.param])


def _block_mask():
    return np.arange(N) // prk.RAY_BLOCK % 2 == 0


def _first_surface(case, o, dirs, skip):
    """Distance and pool id of the first surface (opaque or glass) along
    each ray, by the port's twin; inf and -1 where there is none."""
    d = case["cfg"].d
    if case["cfg"].has_transparency:
        t, slot, tt, ts, _ = prk.nearest_hit_transparent_hbm_ref(
            case["pres"], _t(o.T), _t(dirs.T), _t(skip), d, 8)
        all_t = np.concatenate([np.where(slot.numpy() >= 0, t.numpy(),
                                         np.inf)[None], tt.numpy()])
        slots = np.concatenate([slot.numpy()[None], ts.numpy()])
        k = all_t.argmin(axis=0)[None]
        first = np.take_along_axis(all_t, k, axis=0)[0]
        slot = np.take_along_axis(slots, k, axis=0)[0]
    else:
        t, slot, _ = prk.nearest_hit_ref(case["pres"], _t(o.T), _t(dirs.T),
                                         _t(skip), d)
        slot = slot.numpy()
        first = np.where(slot >= 0, t.numpy(), np.inf)
    pid = case["arrs"]["res_ids"][:, 0, :].reshape(-1)[np.clip(slot, 0, None)]
    return first, np.where(np.isfinite(first), pid, -1).astype(np.int32)


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
    _first, pid = _first_surface(case, o, dirs, np.full((N,), -1, np.int32))
    skip = np.where(np.arange(N) % 2 == 0, pid, -1).astype(np.int32)
    return o, dirs, skip, _block_mask()


def _walk_inputs(case, mode):
    """(o, dirs, skip, JAX keywords, port keywords) of a nearest walk."""
    if mode == "primary":
        return (case["o"], case["dirs"], np.full((N,), -1, np.int32),
                dict(order=jnp.asarray(case["pctx"]["order"]),
                     dmin=jnp.asarray(case["pctx"]["dmin"]),
                     sh=jnp.asarray(case["pctx"]["sh_res"])),
                dict(order=_t(case["pctx"]["order"]),
                     sh=_t(case["pctx"]["sh_res"])))
    o, dirs, skip, active = _bounce_inputs(case)
    return (o, dirs, skip, dict(active=jnp.asarray(active)),
            dict(active=_t(active)))


def _shadow_inputs(case, light):
    """Shadow rays from the first surface along each primary ray, skipping
    it, every other block dead: towards a point light (finite distances)
    or along a global light (the distance cut to the pool's box)."""
    d = case["cfg"].d
    first, pid = _first_surface(case, case["o"], case["dirs"],
                                np.full((N,), -1, np.int32))
    m = np.isfinite(first)
    point = np.where(m[:, None], case["o"] + np.where(m, first, 0)[:, None]
                     * case["dirs"], 0).astype(np.float32)
    live = m & _block_mask()
    if light == "point":
        pos = np.zeros(d, np.float32)
        pos[0], pos[1], pos[2] = -1, 2, -3
        lv = point - pos
        dist = np.sqrt((lv * lv).sum(axis=1)).astype(np.float32)
        dirs = (lv / dist[:, None]).astype(np.float32)
        ldist = np.where(live, dist, 0).astype(np.float32)
    else:
        g = np.zeros(d, np.float32)
        g[1], g[2] = 1, 0.25
        dirs = np.tile(g / np.linalg.norm(g), (N, 1)).astype(np.float32)
        exit_t = prk._scene_exit_T(_t(point.T), _t(dirs.T),
                                   case["tens"]["res_blo"],
                                   case["tens"]["res_bhi"]).numpy()
        ldist = np.where(live, np.minimum(REAL_MAX, exit_t), 0) \
            .astype(np.float32)
    return point, dirs, ldist, pid, live


@pytest.mark.parametrize("mode", ["primary", "bounce"])
def test_nearest_hit_hbm_ref_matches_pallas(opaque, mode):
    d = opaque["cfg"].d
    o, dirs, skip, jkw, pkw = _walk_inputs(opaque, mode)
    jt, jslot, jvis = jrk.nearest_hit_hbm(
        opaque["jres"], jnp.asarray(o), jnp.asarray(dirs), jnp.asarray(skip),
        d, raw_slot=True, **jkw)
    jt, jslot, jvis = np.asarray(jt), np.asarray(jslot), np.asarray(jvis)
    pt, pslot, pvis = prk.nearest_hit_ref(
        opaque["pres"], _t(o.T), _t(dirs.T), _t(skip), d, **pkw)
    pt, pslot, pvis = pt.numpy(), pslot.numpy(), pvis.numpy()
    hits = jslot >= 0
    assert hits.sum() > (100 if mode == "primary" else 20)
    assert np.array_equal(pslot, jslot)
    assert np.array_equal(pvis, jvis)
    bound = _t_rounding_bound(o, dirs, jslot, opaque["arrs"], d)
    assert (np.abs(pt - jt) <= 1e-6 * np.abs(jt) + bound)[hits].all()
    assert np.array_equal(pt[~hits], jt[~hits])
    if mode == "bounce":
        assert (pvis[1::2] == 0).all() and pvis[0::2].any()


@pytest.mark.parametrize("light", ["point", "global"])
def test_occluded_hbm_ref_matches_pallas(opaque, light):
    d = opaque["cfg"].d
    point, dirs, ldist, skip, live = _shadow_inputs(opaque, light)
    pb, pv = prk.occluded_ref(opaque["pres"], _t(point.T), _t(dirs.T),
                              _t(ldist), _t(skip), d)
    pb, pv = pb.numpy(), pv.numpy()
    jb, jv = jrk.occluded_hbm(opaque["jres"], jnp.asarray(point),
                              jnp.asarray(dirs), jnp.asarray(ldist),
                              jnp.asarray(skip), d)
    jb, jv = np.asarray(jb), np.asarray(jv)
    assert pb.dtype == np.bool_ and np.array_equal(pb, jb), \
        f"{int((pb != jb).sum())} rays differ"
    assert np.array_equal(pv, jv)
    print(f"{opaque['name']} {light}: {int(live.sum())} live, "
          f"{int(pb.sum())} blocked")
    assert not pb[~live].any()
    assert (pv[1::2] == 0).all() and pv[0::2].any()
    if opaque["name"] == "3d_mirror_1500":
        assert pb[live].any() and not pb[live].all()


def _walks(case, wrapped):
    """The outputs of a case's two walks over the line (nearest in bounce
    mode, occlusion towards a point light): through the wrappers
    (``wrapped``) or straight from the twins."""
    d = case["cfg"].d
    o, dirs, skip, _jkw, pkw = _walk_inputs(case, "bounce")
    args = (case["pres"], _t(o.T), _t(dirs.T), _t(skip), d)
    point, sdirs, ldist, sskip, _live = _shadow_inputs(case, "point")
    oargs = (case["pres"], _t(point.T), _t(sdirs.T), _t(ldist), _t(sskip), d)
    if case["cfg"].has_transparency:
        if wrapped:
            return prk.nearest_hit_transparent_hbm(*args, 4, **pkw) \
                + prk.occluded_transparent(*oargs)
        return prk.nearest_hit_transparent_hbm_ref(*args, 4, **pkw) \
            + prk.occluded_transparent_ref(*oargs)
    if wrapped:
        return prk.nearest_hit(*args, **pkw) + prk.occluded(*oargs)
    return prk.nearest_hit_ref(*args, **pkw) + prk.occluded_ref(*oargs)


WALKS = ("nearest_hit", "occluded", "nearest_hit_transparent_hbm",
         "occluded_transparent")


def _wrappers_take_the_twins(case):
    before = [getattr(prk, n).launches for n in WALKS]
    got, ref = _walks(case, True), _walks(case, False)
    assert len(got) == len(ref) == (8 if case["cfg"].has_transparency else 5)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert before == [getattr(prk, n).launches for n in WALKS]


def test_streaming_wrappers_take_the_twins_on_cpu(opaque):
    _wrappers_take_the_twins(opaque)


def test_twin_step_follows_the_slab():
    """A twin takes as many 512-ray blocks together as keep a (blocks, 512,
    width) slab within TWIN_SLAB elements: width n_eff for the entry pass,
    128 for the walk's pair tests."""
    assert prk._twin_step(prk.CK, "cuda") == (1 << 29) // (512 * 128) == 8192
    assert prk._twin_step(27, "cuda") == (1 << 29) // (512 * 27)
    assert prk._twin_step(4054, "cuda") == 258        # the 500k mesh's pool
    assert prk._twin_step(16383, "cuda") == (1 << 29) // (512 * 16383) == 64
    assert prk._twin_step(prk.CK, "cpu") == 16
    assert prk._twin_step(200, "cpu") == (1 << 20) // (512 * 200) == 10
    assert prk._twin_step(4054, "cpu") == 1


def _equal_at_two_step_sizes(case, monkeypatch):
    """Blocks walk independently: all eight blocks in one step or one block
    a step, in the entry pass and in the walk, give the same outputs."""
    n = case["pres"]["n_eff"]
    assert prk._twin_step(n, "cpu") >= 8 and prk._twin_step(prk.CK, "cpu") >= 8
    wide = _walks(case, False)
    monkeypatch.setitem(prk.TWIN_SLAB, "cpu", 512)
    assert prk._twin_step(n, "cpu") == prk._twin_step(prk.CK, "cpu") == 1
    narrow = _walks(case, False)
    for a, b in zip(wide, narrow):
        assert torch.equal(a, b)


def test_twin_walks_equal_at_two_step_sizes(opaque, monkeypatch):
    _equal_at_two_step_sizes(opaque, monkeypatch)


def test_pool_line_is_the_jax_packages():
    """``pool_bytes`` counts as ``pool_vmem_bytes`` does (padded plane,
    offset and id rows, no opacity row) and the line is the same 48 MiB."""
    assert prk.STREAM_POOL_BYTES == jrk.POOL_VMEM_BUDGET == 48 << 20
    for n, d in ((1500, 3), (295_932, 3), (495_612, 3), (3240, 4),
                 (900, 6), (100, 8)):
        assert prk.pool_bytes(n, d) == jrk.pool_vmem_bytes(n, d)
    # the 500k-triangle sphere of scripts/bench_mesh.py is over the line,
    # the 300k one under it
    assert prk.pool_bytes(4054 * 128, 3) > prk.STREAM_POOL_BYTES
    assert prk.pool_bytes(2349 * 128, 3) <= prk.STREAM_POOL_BYTES


def test_streaming_wrappers_refuse_other_devices(opaque):
    d = opaque["cfg"].d
    meta = torch.zeros((d, prk.RAY_BLOCK), device="meta")
    skip = torch.zeros((prk.RAY_BLOCK,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        prk.occluded(opaque["pres"], meta, meta,
                     torch.zeros(prk.RAY_BLOCK, device="meta"), skip, d)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        prk.occluded_transparent(opaque["pres"], meta, meta,
                                 torch.zeros(prk.RAY_BLOCK, device="meta"),
                                 skip, d)
