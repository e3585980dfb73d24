"""Pools over the line (``resident_kernels.STREAM_POOL_BYTES``, the JAX
package's ``POOL_VMEM_BUDGET``; both monkeypatched to 1 KiB here) through
whole frames: the port takes its streaming walks (``*_hbm``) where the JAX
package takes its own, and renders what the JAX package renders.

Tolerance against JAX, as tests/test_torch_glass.py holds lit frames:
colors to rtol 2e-6, atol 2e-7 (XLA on the CPU contracts a*b+c into FMAs,
the port rounds every operation), bytes within one code; the pixels beyond
that are counted and must stay under 0.5% of the frame, each within atol
2e-6: the two roundings of the shading part there by a few 1e-7 (the walks
do not: the port's frame over the line is bit-equal to its frame under
it, and its walks equal the JAX kernels, tests/test_torch_hbm.py).  The
JAX side renders two whole frames in this file, each through its Pallas
``*_hbm`` kernels in interpret mode.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu.engine import packing as jpack
from ntracer_tpu.engine import resident_kernels as jrk
from ntracer_tpu_torch import BlockingRenderer
from ntracer_tpu_torch.engine import wavefront as pwf
from ntracer_tpu_torch.engine import resident_kernels as prk

from _torch_helpers import (JAX, PORT, glass_scene, mirror_scene_1500,
                            jax_device_scene, rgb8)
from test_torch_frame import _jax_frame_colors

W = H = 24

SCENES = {
    # tests/test_pallas.py's scene over the line: a mirror under a point
    # light, shadows on (one bounce, two shadow walks a frame)
    "3d_mirror_1500": lambda pkg: mirror_scene_1500(pkg=pkg),
    # glass and opaque by turns under two lights (the K-slot walk and the
    # filtered shadow walks)
    "3d_glass_600": lambda pkg: glass_scene(600, lit=True, pkg=pkg),
}
WALKS = ("nearest_hit", "occluded", "nearest_hit_transparent",
         "occluded_transparent")


def _spy(monkeypatch):
    """Record which of the eight walk wrappers the port calls."""
    calls = []
    for name in WALKS + tuple(w + "_hbm" for w in WALKS):
        fn = getattr(prk, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(prk, name, spy)
    return calls


@pytest.mark.parametrize("name", sorted(SCENES))
def test_frame_over_the_line_matches_jax(name, monkeypatch):
    monkeypatch.setattr(jrk, "POOL_VMEM_BUDGET", 1024)
    monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    jscene, pscene = SCENES[name](JAX), SCENES[name](PORT)
    _jcfg, jarrs, _ = jax_device_scene(jscene, monkeypatch)
    pcfg, parrs, _ = pwf.get_device_scene(pscene, "cpu")
    # both packages put the pool over the line, with the same layouts
    assert "res_is_hbm" in jarrs and "res_is_hbm" in parrs
    for k in ("res_gt", "res_ci", "res_ids", "res_klo", "res_khi"):
        assert np.array_equal(parrs[k].numpy(), jarrs[k]), k
    calls = _spy(monkeypatch)
    got = pwf.frame_colors(pscene, W, H, "cpu")
    walks = set(calls)
    print(f"{name}: walks {sorted(walks)}, {len(calls)} calls")
    assert walks and all(w.endswith("_hbm") for w in walks)
    if pcfg.has_transparency:
        assert walks == {"nearest_hit_transparent_hbm",
                         "occluded_transparent_hbm"}
    else:
        assert walks == {"nearest_hit_hbm", "occluded_hbm"}
    ref = _jax_frame_colors(jscene, W, H)
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    assert (got.max(axis=2) > 0).sum() > W * H // 4
    beyond = ~np.isclose(got, ref, rtol=2e-6, atol=2e-7).all(axis=2)
    print(f"{name}: {int(beyond.sum())} of {W * H} pixels beyond rtol 2e-6 "
          f"/ atol 2e-7, worst {float(np.abs(got - ref).max())}")
    assert beyond.sum() <= W * H // 200
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)
    fmt = rgb8(W, H)
    buf = bytearray(fmt.pitch * H)
    assert BlockingRenderer(device="cpu").render(buf, fmt, pscene)
    ref_bytes = np.asarray(jpack.pack_device(
        jnp.asarray(ref.reshape(-1, 3)), jpack.format_key(fmt)))
    diff = np.abs(np.frombuffer(bytes(buf), np.uint8).astype(int)
                  - ref_bytes.reshape(-1).astype(int))
    assert diff.max() <= 1


def test_opaque_frame_is_the_same_over_and_under_the_line(monkeypatch):
    """The streaming walks compute what the resident ones compute: the same
    scene forced over the line renders the same colors, bit for bit."""
    scene = SCENES["3d_mirror_1500"](PORT)
    under = pwf.frame_colors(scene, 2 * W, 2 * H, "cpu")
    assert "res_is_hbm" not in pwf.get_device_scene(scene, "cpu")[1]
    monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    scene._mutate()                     # rebuild the device scene
    calls = _spy(monkeypatch)
    over = pwf.frame_colors(scene, 2 * W, 2 * H, "cpu")
    assert "res_is_hbm" in pwf.get_device_scene(scene, "cpu")[1]
    assert set(calls) == {"nearest_hit_hbm", "occluded_hbm"}
    assert np.array_equal(over.view(np.int32), under.view(np.int32))


def test_the_line_counts_as_the_jax_package(monkeypatch):
    """A pool exactly at the line stays resident, one chunk more streams;
    the port and the JAX package agree on both sides."""
    scene = SCENES["3d_mirror_1500"](PORT)
    arrs = pwf.get_device_scene(scene, "cpu")[1]
    n_chunks = arrs["res_gt"].shape[0]
    at = prk.pool_bytes(n_chunks * prk.CK, 3)
    for line, over in ((at, False), (at - 1, True)):
        monkeypatch.setattr(prk, "STREAM_POOL_BYTES", line)
        scene._mutate()
        assert ("res_is_hbm" in pwf.get_device_scene(scene, "cpu")[1]) \
            == over
        assert (jrk.pool_vmem_bytes(n_chunks * jrk.CK, 3) > line) == over

