"""The chunk scan of ntracer_tpu_torch (``wavefront.trace_scan``,
``occlusion_scan``: transparent pools of d > 8) vs the JAX package's XLA
scan, which the JAX package runs on the CPU without NTRACER_FORCE_KERNELS,
and whole frames vs the JAX package and the scalar oracle.

Tolerances: ids (pid, every K slot) and ``blocked`` exact on rays aimed
inside simplices (away from their edges, where the two engines' plane dots,
summed in different orders, may flip a fuzz test); t within the rounding
bound of its numerator; ``filt`` within the rounding of its product on
unblocked rays; visits equal for the same group of rays.  Frames: against
JAX rtol 2e-6, atol 2e-7 and bytes within one code; against the oracle 5e-5
(5e-4 on composed pixels) on pixels whose rays hold fewer than K glass
surfaces.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ntracer_tpu.engine import packing as jpack
from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu_torch import BlockingRenderer, kdnodes
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import (JAX, PORT, _smoke, orthoplex_scene, rgb8,
                            solid_orthoplex_scene)
from test_torch_frame import _jax_frame_colors
from test_torch_solids import U, _tri_t_bound

D = 9
N = 8192        # rays aimed at the scene: one scan group (SCAN_RAYS)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def case():
    """The glass 9-orthoplex with its shading companion (1,024 simplices,
    two chunks, by turns opaque and glass) in both packages, the JAX device
    scene of its XLA scan, and N rays from the camera aimed inside the big
    orthoplex's simplices: one scan group of either package."""
    jscene = orthoplex_scene(D, pkg=JAX, glass=True, companion="shade")
    pscene = orthoplex_scene(D, pkg=PORT, glass=True, companion="shade")
    jcfg, jdev, _ = jwf.get_device_scene(jscene)
    pcfg, parrs, _ = pwf.get_device_scene(pscene, "cpu")
    assert pcfg == pwf.SceneConfig(**{k: v for k, v in vars(jcfg).items()
                                      if k != "prim_axis"})
    assert pcfg.has_transparency and pcfg.n_tris == 1024
    assert N <= pwf.SCAN_RAYS
    smoke = _smoke()
    simplices = smoke.hull_simplices(smoke.polytope_vertices(
        [3] * (D - 2) + [4]))
    origin = np.asarray(pscene._cam._origin, np.float32)
    dirs = smoke.aimed(origin, simplices, N)
    oT = _t(np.broadcast_to(origin[:, None], dirs.shape))
    return dict(pcfg=pcfg, jcfg=jcfg, parrs=parrs, jdev=jdev,
                arrs={k: np.asarray(v) for k, v in jdev.items()},
                oT=oT, dT=_t(dirs))


def _jax_trace(case, skip, active=None):
    oT, dT = case["oT"], case["dT"]
    stats = {}
    res = jwf.trace_pool(case["jdev"], case["jcfg"], jnp.asarray(oT.numpy().T),
                         jnp.asarray(dT.numpy().T), jnp.asarray(skip),
                         active=None if active is None
                         else jnp.asarray(active), stats=stats)
    return {k: np.asarray(v) for k, v in res.items()}, \
        int(stats["chunks_visited"])


def test_device_arrays_match_jax(case):
    """The scan's arrays (triangle rows, opacity, chunk boxes, ``tri_pack``)
    equal the JAX package's; no grid or chunked walk layout is built."""
    parrs, arrs = case["parrs"], case["arrs"]
    for k in ("tri_p1", "tri_fn", "tri_en", "tri_dc", "tri_opacity", "ck_lo",
              "ck_hi", "ck_nonempty", "tri_pack", "mat_pack", "tri_base"):
        assert parrs[k].numpy().dtype == arrs[k].dtype, k
        assert np.array_equal(parrs[k].numpy(), arrs[k]), k
    assert parrs["ck_nonempty"].tolist() == [True, True]
    assert not any(k.startswith(("kern_", "res_")) for k in parrs)
    assert pwf._scan(parrs) and not pwf._grid(parrs)
    assert pwf.primary_ctx(parrs, case["pcfg"], case["oT"][:, 0]) == {}


@pytest.mark.parametrize("mode", ["primary", "bounce"])
def test_trace_matches_jax_scan(case, mode, monkeypatch):
    """Primary rays, and the same rays as a bounce: every other one
    inactive, each skipping the surface it hit first."""
    cfg, K = case["pcfg"], case["pcfg"].max_transparent_hits
    skip = np.full((N,), -1, np.int32)
    active = None
    if mode == "bounce":
        first, _ = _jax_trace(case, skip)
        skip = first["pid"]
        active = np.arange(N) % 2 == 0
    ref, jvis = _jax_trace(case, skip, active)
    scans = []
    scan = pwf.trace_scan
    monkeypatch.setattr(pwf, "trace_scan",
                        lambda *a, **k: scans.append(scan(*a, **k))
                        or scans[-1])
    got = pwf.trace_pool(case["parrs"], cfg, case["oT"], case["dT"], _t(skip),
                         active=None if active is None else _t(active))
    got = {k: v.numpy() for k, v in got.items()}
    assert len(scans) == 1 and scans[0][4].tolist() == [jvis] and jvis == 2
    assert np.array_equal(got["pid"], ref["pid"])
    assert np.array_equal(got["mat"], ref["mat"])
    h = got["pid"] >= 0
    assert h.sum() > (N // 4 if mode == "primary" else N // 8)
    o, dirs = case["oT"].numpy().T, case["dT"].numpy().T
    bound = _tri_t_bound(o, dirs, got["pid"], case["arrs"], D)
    assert (np.abs(got["t"] - ref["t"]) <= 1e-6 * ref["t"] + bound)[h].all()
    # K slots: the JAX row layout is (R, K)
    assert got["tidT"].shape == (K, N)
    assert np.array_equal(got["tidT"], ref["tid"].T)
    valid = got["tidT"] >= 0
    assert valid.sum() > N // 4
    assert np.array_equal(got["tmatT"][valid], ref["tmat"].T[valid])
    for k in range(K):
        m = valid[k]
        b = _tri_t_bound(o, dirs, got["tidT"][k], case["arrs"], D)
        assert (np.abs(got["ttT"][k] - ref["tt"][:, k])
                <= 1e-6 * ref["tt"][:, k] + b)[m].all()
    np.testing.assert_allclose(got["tnormT"][:, valid],
                               ref["tnorm"].transpose(2, 1, 0)[:, valid],
                               rtol=1e-6, atol=1e-6)
    if active is not None:
        assert (got["pid"][~active] == -1).all()
        assert (got["tidT"][:, ~active] == -1).all()


def test_scan_groups_match_jax_groups(case, monkeypatch):
    """Groups of 2,048 rays: each group runs the chunks the JAX package's
    scan runs for those 2,048 rays, and every ray's result is the JAX
    package's for that group (a ray whose hit lies on a chunk box's face,
    rounded out of it, finds it only when its group runs the chunk)."""
    cfg, n = case["pcfg"], 2048
    monkeypatch.setattr(pwf, "SCAN_RAYS", n)
    skip = np.full((N,), -1, np.int32)
    t, pid, tt, tid, vis = pwf.trace_scan(case["parrs"], cfg, case["oT"],
                                          case["dT"], _t(skip))
    assert vis.shape == (N // n,)
    for i, g in enumerate(range(0, N, n)):
        sl = slice(g, g + n)
        stats = {}
        ref = jwf.trace_pool(case["jdev"], case["jcfg"],
                             jnp.asarray(case["oT"].numpy().T[sl]),
                             jnp.asarray(case["dT"].numpy().T[sl]),
                             jnp.asarray(skip[sl]), stats=stats)
        assert int(vis[i]) == int(stats["chunks_visited"])
        assert np.array_equal(pid[sl].numpy(), np.asarray(ref["pid"]))
        assert np.array_equal(np.where(tt[:, sl].numpy() < t[sl].numpy(),
                                       tid[:, sl].numpy(), -1),
                              np.asarray(ref["tid"]).T)


def _queries(case):
    """Shadow queries from the primary hits: towards the global light
    (ldist REAL_MAX) and away from the point light (its distance), as
    ``shade_local_T`` casts them, with the surface each ray leaves."""
    cfg, parrs = case["pcfg"], case["parrs"]
    hit = pwf.trace_pool(parrs, cfg, case["oT"], case["dT"],
                         torch.full((N,), -1, dtype=torch.int32))
    point = torch.where(hit["hit"][None, :], hit["pointT"], 0.0)
    ld = (-parrs["gl_dir"][0])[:, None].expand_as(point).contiguous()
    yield point, ld, torch.where(hit["hit"], pwf.REAL_MAX, 0.0), hit["pid"]
    lv = point - parrs["pl_pos"][0][:, None]
    dist = pwf.rk._sqrt(pwf._dotT(lv, lv))
    yield (point, (lv / dist[None, :]).contiguous(),
           torch.where(hit["hit"], dist, 0.0), hit["pid"])


def test_occlusion_matches_jax_scan(case, monkeypatch):
    cfg = case["pcfg"]
    blocked = filtered = 0
    scans = []
    scan = pwf.occlusion_scan
    monkeypatch.setattr(pwf, "occlusion_scan",
                        lambda *a, **k: scans.append(scan(*a, **k))
                        or scans[-1])
    for point, lv, ldist, pid in _queries(case):
        pb, pf = pwf.occlusion(case["parrs"], cfg, point, lv, ldist, pid)
        vis = scans.pop()[2]
        stats = {}
        jb, jf = jwf.occlusion(case["jdev"], case["jcfg"],
                               jnp.asarray(point.numpy().T),
                               jnp.asarray(lv.numpy().T),
                               jnp.asarray(ldist.numpy()),
                               jnp.asarray(pid.numpy()), stats=stats)
        pb, pf, jb, jf = pb.numpy(), pf.numpy(), np.asarray(jb), np.asarray(jf)
        assert vis.tolist() == [int(stats["occl_chunks_visited"])]
        assert np.array_equal(pb, jb)
        ub = ~pb
        # a product of at most a few dozen factors (1 - 0.4): 2 x 32
        # roundings
        np.testing.assert_allclose(pf[ub], jf[ub], rtol=64 * U, atol=0)
        assert (pf[ldist.numpy() <= 0] == 1).all()
        blocked += int(pb.sum())
        filtered += int(((pf < 1) & ub).sum())
    print(f"{blocked} blocked and {filtered} filtered queries")
    assert blocked > 100 and filtered > 20


def test_chunk_k_nearest_breaks_ties_as_top_k():
    """``lax.top_k`` of the negated distances: the K smallest, ties to the
    lowest row, the inf fillers too."""
    rng = np.random.RandomState(5)
    tm = rng.choice(np.array([0.5, 1.0, 1.5, 2.0, np.inf], np.float32),
                    size=(512, 300))
    tm[:, :50] = np.inf
    tm[:, 50:60] = 1.0
    tm[7, 60:] = np.float32(3e38)
    for K in (1, 3, 8):
        vals, rows = pwf._chunk_k_nearest(_t(tm), K)
        ref_v, ref_r = jax.lax.top_k(-jnp.asarray(tm.T), K)
        assert np.array_equal(vals.numpy(), -np.asarray(ref_v).T)
        assert np.array_equal(rows.numpy(), np.asarray(ref_r).T)


def test_slab_entry_matches_jax():
    """Bit for bit, rays parallel to an axis (zero direction components)
    and rays starting inside the box included."""
    rng = np.random.RandomState(6)
    o = rng.uniform(-3, 3, (1000, D)).astype(np.float32)
    dv = rng.normal(size=(1000, D)).astype(np.float32)
    dv[::3, 2] = 0
    dv[::7, :4] = 0
    o[::5] = rng.uniform(-0.5, 0.5, (200, D))
    lo = np.full(D, -1, np.float32)
    hi = np.full(D, 1.5, np.float32)
    ref = np.asarray(jwf._slab_entry(jnp.asarray(o), jnp.asarray(dv),
                                     jnp.asarray(lo), jnp.asarray(hi)))
    got = pwf._slab_entry(_t(o.T), _t(dv.T), _t(lo), _t(hi)).numpy()
    assert np.array_equal(got, ref)
    assert np.isinf(got).any() and (got == 0).any()


def test_glass_frame_matches_jax():
    """A 32x32 frame of the glass 9-orthoplex and its companion, lit with
    shadows: the port's transposed pipeline against the JAX package's row
    pipeline over its XLA scan."""
    jscene = orthoplex_scene(D, pkg=JAX, glass=True, companion="shade")
    pscene = orthoplex_scene(D, pkg=PORT, glass=True, companion="shade")
    n = 32
    ref = _jax_frame_colors(jscene, n, n)
    got, masks = pwf.frame_colors(pscene, n, n, "cpu", masks=True)
    print({k: int(v.sum()) for k, v in masks.items()})
    assert masks["hit"].sum() > 100 and masks["layered"].sum() > 100
    assert masks["shadowed"].any() and masks["filtered"].any()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)
    fmt = rgb8(n, n)
    buf = bytearray(fmt.pitch * n)
    assert BlockingRenderer(device="cpu").render(buf, fmt, pscene)
    ref_bytes = np.asarray(jpack.pack_device(
        jnp.asarray(ref.reshape(-1, 3)), jpack.format_key(fmt)))
    diff = np.abs(np.frombuffer(bytes(buf), np.uint8).astype(int)
                  - ref_bytes.reshape(-1).astype(int))
    assert diff.max() <= 1


def test_glass_solid_frame_at_d10_matches_oracle(monkeypatch):
    """The glass 10-orthoplex with a glass sphere beside it (chip_smoke.py's
    "glass orthoplex d=10", one leaf, single triangles) against the oracle:
    pixels seen through glass, lit through glass, on the bodies, any."""
    scene = solid_orthoplex_scene(10, glass=True)
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    assert cfg.d == 10 and cfg.n_solids == 1 and pwf._scan(arrs)
    n = 64
    colors, masks = pwf.frame_colors(scene, n, n, "cpu", masks=True)
    print({k: int(v.sum()) for k, v in masks.items()})
    assert masks["layered"].sum() > 200 and masks["filtered"].any()
    monkeypatch.setattr(kdnodes, "OCCLUDES_EARLY_OUT", False)
    scene._set_view_size(n, n)
    rng = np.random.RandomState(4)
    pixels = []
    for name, k in (("layered", 20), ("filtered", 8), ("hit", 12),
                    (None, 8)):
        mask = np.ones((n, n), bool) if name is None else masks[name]
        ys_, xs_ = np.nonzero(mask & ~masks["full"])
        pixels += [(int(xs_[i]), int(ys_[i]))
                   for i in rng.choice(len(xs_), k)]
    for x, y in pixels:
        tol = 5e-4 if masks["layered"][y, x] else 5e-5
        diff = float(np.abs(scene._pixel_color(x, y) - colors[y, x]).max())
        assert diff < tol, (x, y, diff)
