"""Pixel (px) sharding of ntracer_tpu_torch (``parallel.mesh``) on the CPU:
the counterparts of tests/test_engine.py's px mesh tests.

A mesh on the CPU repeats the CPU device (``make_mesh(..., devices=[cpu] *
8)``): every path of the sharding runs, the shards one after another.  The
port's sharded frames are held to its single-device frame (which the other
frame tests hold to the JAX package), two of them to the JAX package's
``pmesh.render_frame`` and its 8-device ``BlockingRenderer``: colors within
2e-5, bytes within one code.
"""

import numpy as np
import pytest
import torch

from ntracer_tpu.parallel import mesh as jmesh
from ntracer_tpu.render import BlockingRenderer as JaxRenderer
from ntracer_tpu_torch import BlockingRenderer, CallbackRenderer, NTracer
from ntracer_tpu_torch.engine import packing
from ntracer_tpu_torch.engine import wavefront as pwf
from ntracer_tpu_torch.parallel import mesh as pmesh

from _torch_helpers import JAX, PORT, api, formats, random_scene, rgb8

CPU = torch.device("cpu")
EIGHT = [CPU] * 8


def _scene(seed, pkg=PORT, n=40):
    """tests/test_engine.py's ``_random_scene`` (spread 0.8)."""
    return random_scene(3, n=n, seed=seed, spread=0.8, pkg=pkg)


def _codes(colors, fmt):
    """8-bit codes of (H, W, 3) colors, as int."""
    flat = colors.reshape(-1, 3)
    return packing.pack_flat(flat, fmt).astype(int)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_render_matches_single(shape):
    scene = _scene(2)
    w = h = 24
    single = pwf.frame_colors(scene, w, h, CPU)
    mesh = pmesh.make_mesh(*shape, devices=EIGHT)
    assert mesh.shape == {"px": shape[0], "prim": shape[1]}
    sharded = pmesh.render_frame(scene, rgb8(w, h), mesh)
    assert sharded.shape == (h, w, 3)
    np.testing.assert_allclose(sharded, single, rtol=0, atol=1e-5)


def test_sharded_render_matches_jax():
    """The 8x1 frame against the JAX package's ``pmesh.render_frame`` on its
    eight CPU devices."""
    w = h = 24
    sharded = pmesh.render_frame(_scene(2), rgb8(w, h),
                                 pmesh.make_mesh(8, 1, devices=EIGHT))
    jscene = _scene(2, pkg=JAX)
    ref = jmesh.render_frame(jscene, rgb8(w, h, JAX), jmesh.make_mesh(8, 1))
    np.testing.assert_allclose(sharded, ref, rtol=0, atol=2e-5)
    fmt = rgb8(w, h)
    assert np.abs(_codes(sharded, fmt) - _codes(ref, fmt)).max() <= 1


@pytest.mark.parametrize("n_px", [1, 2, 4, 8])
def test_px_scaling_fixed_per_shard(n_px):
    """The frame grows with the shard count so that every shard renders
    the same 128 rays, and the frame equals the single-device frame at
    every mesh size."""
    w, h = 32, 4 * n_px
    scene = _scene(7)
    single = pwf.frame_colors(scene, w, h, CPU)
    sharded = pmesh.render_frame(scene, rgb8(w, h),
                                 pmesh.make_mesh(n_px, 1, devices=EIGHT))
    np.testing.assert_allclose(sharded, single, rtol=0, atol=1e-5)
    assert -(-w * h // n_px) == 32 * 4


def _devices(monkeypatch, devices):
    monkeypatch.setattr(pwf, "render_devices", lambda device: devices)


def test_render_packed_multidevice_swizzled_tiles(monkeypatch):
    """BlockingRenderer over eight CPU "devices" takes the px mesh with the
    32x16-pixel tile order active in each shard (512 pixels, 16 rows of
    32): its bytes equal the single device's, and the JAX package's
    8-device frame within one code."""
    w, h = 32, 128
    fmt = rgb8(w, h)
    _xs, _ys, swz = pwf._ray_coords(0, w, 512, "cpu")
    assert swz is not None, "the test's geometry must take the tile order"
    scene = _scene(9, n=60)
    r = BlockingRenderer(device="cpu")
    single = bytearray(fmt.pitch * h)
    assert r.render(single, fmt, scene)
    _devices(monkeypatch, EIGHT)
    calls = []
    inner = pmesh.dispatch_sharded
    monkeypatch.setattr(pmesh, "dispatch_sharded",
                        lambda *a: calls.append(1) or inner(*a))
    slabs = pwf.dispatch_packed(scene, fmt, "cpu")
    assert [s for s, _t, _r in slabs] == [512 * i for i in range(8)]
    multi = bytearray(fmt.pitch * h)
    assert r.render(multi, fmt, scene)
    assert calls
    assert bytes(multi) == bytes(single)
    jbuf = bytearray(fmt.pitch * h)
    assert JaxRenderer().render(jbuf, rgb8(w, h, JAX), _scene(9, JAX, n=60))
    diff = np.abs(np.frombuffer(multi, np.uint8).astype(int)
                  - np.frombuffer(jbuf, np.uint8).astype(int))
    assert diff.max() <= 1


@pytest.mark.parametrize("fmt_name", ["rgb565", "float"])
def test_render_packed_multidevice_formats(monkeypatch, fmt_name):
    """Other formats over three "devices" (the last shard's pixels past
    the frame's end): the single device's bytes."""
    w, h = 40, 24
    fmt = formats(w, h)[fmt_name]
    scene = _scene(5)
    single = bytearray(fmt.pitch * h)
    assert BlockingRenderer(device="cpu").render(single, fmt, scene)
    _devices(monkeypatch, [CPU] * 3)
    multi = bytearray(fmt.pitch * h)
    assert BlockingRenderer(device="cpu").render(multi, fmt, scene)
    assert bytes(multi) == bytes(single)


def test_render_packed_multidevice_wide_channels(monkeypatch):
    """A format the host packs (a channel wider than 23 bits) ships float
    colors from every shard."""
    a = api()
    w, h = 32, 32
    fmt = a.ImageFormat(w, h, [a.Channel(30, 1, 0, 0), a.Channel(30, 0, 1, 0),
                               a.Channel(4, 0, 0, 1)])
    assert pwf._needs_host_pack(fmt)
    scene = _scene(3)
    single = bytearray(fmt.pitch * h)
    assert BlockingRenderer(device="cpu").render(single, fmt, scene)
    _devices(monkeypatch, [CPU] * 4)
    slabs = pwf.dispatch_packed(scene, fmt, "cpu")
    assert len(slabs) == 2 and slabs[0][1].dtype == torch.float32
    multi = bytearray(fmt.pitch * h)
    assert BlockingRenderer(device="cpu").render(multi, fmt, scene)
    assert bytes(multi) == bytes(single)


def test_box_scene_multidevice(monkeypatch):
    nt = NTracer(4)
    scene = nt.BoxScene()
    cam = scene.get_camera()
    cam.translate(nt.Vector(0.1, -0.2, -4, 0.3))
    scene.set_camera(cam)
    fmt = rgb8(64, 32)
    single = bytearray(fmt.pitch * 32)
    assert BlockingRenderer(device="cpu").render(single, fmt, scene)
    _devices(monkeypatch, [CPU] * 4)
    multi = bytearray(fmt.pitch * 32)
    assert BlockingRenderer(device="cpu").render(multi, fmt, scene)
    assert bytes(multi) == bytes(single)


def test_callback_renderer_multidevice(monkeypatch):
    """CallbackRenderer pulls every shard's slab of a px-sharded frame."""
    import threading
    fmt = rgb8(32, 64)
    scene = _scene(4)
    single = bytearray(fmt.pitch * 64)
    assert BlockingRenderer(device="cpu").render(single, fmt, scene)
    _devices(monkeypatch, [CPU] * 4)
    done = threading.Event()
    buf = bytearray(fmt.pitch * 64)
    cr = CallbackRenderer(device="cpu")
    cr.begin_render(buf, fmt, scene, lambda ok: done.set())
    assert done.wait(timeout=120)
    assert bytes(buf) == bytes(single)


def test_one_device_takes_no_mesh(monkeypatch):
    """With one device the mesh module is not entered, and the frame runs
    the single-device pass."""
    def refuse(*a):
        raise AssertionError("the mesh path was taken")

    monkeypatch.setattr(pmesh, "dispatch_sharded", refuse)
    fmt = rgb8(32, 32)
    buf = bytearray(fmt.pitch * 32)
    assert BlockingRenderer(device="cpu").render(buf, fmt, _scene(2))
    assert pwf.render_devices("cpu") == [CPU]
    assert pwf.render_devices("cuda:1") == [torch.device("cuda", 1)]
    if not torch.cuda.is_available():
        assert pwf.render_devices("cuda") == []


def test_make_mesh_refuses():
    """No fallback hides a device: too few devices, none, or a list that
    mixes device types raise; a repeated device is a mesh."""
    with pytest.raises(ValueError, match="needs 4 devices"):
        pmesh.make_mesh(2, 2, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="no device"):
        pmesh.make_mesh(1, 1, devices=[])
    with pytest.raises(ValueError, match="one type"):
        pmesh.make_mesh(2, 1, devices=[CPU, torch.device("cuda", 0)])
    with pytest.raises(ValueError):
        pmesh.make_mesh(0, 1, devices=[CPU])
    if not torch.cuda.is_available():
        # the default is every card: none here
        with pytest.raises(ValueError, match="no device"):
            pmesh.make_mesh(1)
    m = pmesh.make_mesh(2, 3, devices=["cpu"] * 7)
    assert m.devices.shape == (2, 3)
    assert all(d == CPU for d in m.devices.flat)


def test_mesh_cache_follows_the_scene():
    """The mesh's device arrays are cached on the scene and dropped when
    its geometry changes."""
    scene = _scene(2)
    fmt = rgb8(16, 16)
    mesh = pmesh.make_mesh(2, 2, devices=EIGHT)
    pmesh.render_frame(scene, fmt, mesh)
    rows, _cfg = pmesh._mesh_arrays(scene, mesh)
    assert pmesh._mesh_arrays(scene, mesh)[0] is rows
    nt = NTracer(3)
    scene.add_light(nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)))
    assert scene._torch_mesh_cache is None
    assert pmesh._mesh_arrays(scene, mesh)[0] is not rows
