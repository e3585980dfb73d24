"""The frame's post-walk glue kernel (``csrc/shade_pack.cu``) on the card:
its packed stream equals the plain chain's (``_ray_colors_T`` and
``packing.pack_device_stream``) byte for byte on the benchmark's 120-cell
and 10-orthoplex at 1920x1080 in 16 bits, on a streaming d = 3 pool at
1024x1024 in 8 bits, in formats with a float channel, a reversed byte order
and 5-6-5, at a size that does not allow the tile swizzle and with the
camera light off; replayed frames equal eager ones with the capture's walk
calls unchanged; a frame the kernel does not take runs the chain.  Every
test here is marked ``gpu`` and skips without a card; the file imports no
jax:

    python -m pytest -m gpu --noconftest -p no:cacheprovider \\
        tests/test_torch_shade_pack_gpu.py
"""

import numpy as np
import pytest
import torch

from ntracer_tpu_torch import BlockingRenderer
from ntracer_tpu_torch.engine import graphs
from ntracer_tpu_torch.engine import packing
from ntracer_tpu_torch.engine import resident_kernels as prk
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import (api, bench_scene, formats, glass_scene,
                            lit_scene, orthoplex_scene, random_scene, rgb8,
                            solids_d4_scene, unlit_reflective_scene,
                            wide_d17_scene)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _video_fmt(w=1920, h=1080):
    a = api()
    return a.ImageFormat(w, h, [a.Channel(16, 1, 0, 0), a.Channel(16, 0, 1, 0),
                                a.Channel(16, 0, 0, 1)])


def fused_and_chain(scene, fmt, dev):
    """The frame of ``scene`` in ``fmt`` on ``dev`` eagerly through
    ``_frame`` and through the chain (``_frame_packed_composite`` without
    ``fused``): (kernel's stream, chain's stream, the frame's counters)."""
    scene._torch_graphs = None
    key = packing.format_key(fmt)
    w, h = fmt.width, fmt.height
    before = pwf.shade_pack.launches
    stats = {}
    got = pwf._frame(scene, w, h, key, dev, stats=stats)
    launched = pwf.shade_pack.launches - before
    cfg, arrs, _ = pwf.get_device_scene(scene, dev)
    fov, cam_o, cam_t = pwf._camera(scene, w, h, dev)
    want = pwf._frame_packed_composite(
        arrs, cfg, pwf._scene_dyn(scene, dev), cam_o, cam_t, fov,
        pwf._frame_groups(-(-(w * h) // pwf.TILE)), w, key)
    torch.cuda.synchronize()
    stats = {k: int(v) for k, v in stats.items()}
    stats["launched"] = launched
    return got.cpu(), want.cpu(), stats


def _equal(got, want, label):
    g = got.numpy().view(np.uint8).reshape(-1)
    w = want.numpy().view(np.uint8).reshape(-1)
    bad = np.flatnonzero(g != w)
    assert not len(bad), (label, len(bad), bad[:8], g[bad[:8]], w[bad[:8]])


@pytest.mark.parametrize("config", ["polytope_120cell",
                                    "polytope_orthoplex_d10"])
@pytest.mark.parametrize("step", [0, 61, 140])
def test_cell_frames_equal_the_chain(cuda, config, step):
    got, want, stats = fused_and_chain(bench_scene(config, step), _video_fmt(),
                                       cuda)
    assert stats["glue_fused"] == 1 and stats["launched"] == 1
    _equal(got, want, (config, step))


def test_streaming_mesh_frame_equals_the_chain(cuda, monkeypatch):
    """A d = 3 pool over the line (the streaming walk, kernel 2.5, as the
    mesh cell's) at 1024x1024 in 8 bits."""
    monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1 << 20)
    scene = random_scene(3, n=20000, seed=5, spread=0.3)
    got, want, stats = fused_and_chain(scene, rgb8(1024, 1024), cuda)
    assert pwf._streams(pwf.get_device_scene(scene, cuda)[1])
    assert stats["glue_fused"] == 1 and stats["launched"] == 1
    _equal(got, want, "mesh")


@pytest.mark.parametrize("name", ["float", "bgra_reversed", "rgb565",
                                  "rgb48"])
@pytest.mark.parametrize("size", [(640, 480), (1000, 700)],
                         ids=["tiled", "untiled"])
def test_formats_equal_the_chain(cuda, name, size):
    """The 120-cell in each of the frame tests' formats, at a size whose
    groups are tiled and at one whose are not (1000 is not a multiple of
    the tile's 32 pixels)."""
    w, h = size
    scene = bench_scene("polytope_120cell", 17)
    groups = pwf._frame_groups(-(-(w * h) // pwf.TILE))
    assert any(s for *_r, s in pwf._group_runs(groups, w)) == (w == 640)
    got, want, stats = fused_and_chain(scene, formats(w, h)[name], cuda)
    assert stats["glue_fused"] == 1
    _equal(got, want, (name, size))


@pytest.mark.parametrize("config", ["polytope_120cell",
                                    "polytope_orthoplex_d10"])
def test_camera_light_off_equals_the_chain(cuda, config):
    scene = bench_scene(config, 61)
    scene.set_camera_light(False)
    got, want, stats = fused_and_chain(scene, _video_fmt(640, 480), cuda)
    assert stats["glue_fused"] == 1
    _equal(got, want, config)


def test_replayed_frames_equal_eager_frames(cuda):
    """Three frames of the orthoplex cell through ``BlockingRenderer``: the
    first eager, the second captured and replayed, the third replayed;
    each equal to the chain's frame; the capture cuts at the one walk
    launch as before (two segments), the kernel inside the last; the
    replayed frames count ``glue_fused``."""
    fmt = _video_fmt()
    scene = bench_scene("polytope_orthoplex_d10", 30)
    key = packing.format_key(fmt)
    renderer = BlockingRenderer()
    outs, counted = [], []
    for _ in range(3):
        buf = bytearray(fmt.pitch * fmt.height)
        assert renderer.render(buf, fmt, scene)
        outs.append(bytes(buf))
    (entry,) = graphs._entries(scene).values()
    assert len(entry.calls) == 1 and len(entry.graphs) == 2
    for _ in range(2):
        stats = {}
        pwf._frame(scene, fmt.width, fmt.height, key, cuda, stats=stats)
        counted.append({k: int(v) for k, v in stats.items()})
    assert [c["glue_graph_replays"] for c in counted] == [0, 1]
    assert [c["glue_fused"] for c in counted] == [1, 1]
    _got, want, _stats = fused_and_chain(scene, fmt, cuda)
    want = want.numpy().view(np.uint8).reshape(-1)[:fmt.pitch * fmt.height]
    assert outs[0] == outs[1] == outs[2] == want.tobytes()


def _wide_format(w, h):
    a = api()
    return a.ImageFormat(w, h, [a.Channel(30, 1, 0, 0), a.Channel(30, 0, 1, 0),
                                a.Channel(4, 0, 0, 1)])


# frames the kernel does not take: (scene maker, format)
CHAIN = {
    "lit": (lambda: lit_scene(6), rgb8),
    "glass": (lambda: glass_scene(lit=True), rgb8),
    "solids": (solids_d4_scene, rgb8),
    "reflective": (unlit_reflective_scene, rgb8),
    "lit_orthoplex": (lambda: orthoplex_scene(10), rgb8),
    "d17": (wide_d17_scene, rgb8),
    "wide_format": (lambda: random_scene(3, n=300), _wide_format),
}


@pytest.mark.parametrize("name", sorted(CHAIN))
def test_other_frames_run_the_chain(cuda, name):
    make, fmt = CHAIN[name]
    scene = make()
    fmt = fmt(256, 256)
    wide = pwf._needs_host_pack(fmt)
    key = None if wide else packing.format_key(fmt)
    scene._torch_graphs = None
    before = pwf.shade_pack.launches
    stats = {}
    got = pwf._frame(scene, 256, 256, key, cuda, stats=stats)
    assert stats["glue_fused"] == 0
    assert pwf.shade_pack.launches == before
    cfg, arrs, _ = pwf.get_device_scene(scene, cuda)
    fov, cam_o, cam_t = pwf._camera(scene, 256, 256, cuda)
    want = pwf._frame_packed_composite(
        arrs, cfg, pwf._scene_dyn(scene, cuda), cam_o, cam_t, fov,
        pwf._frame_groups(-(-(256 * 256) // pwf.TILE)), 256, key)
    assert torch.equal(got, want)


def test_masks_and_px_mesh_frames_run_the_chain(cuda, monkeypatch):
    """``frame_colors(masks=True)`` and a frame split by pixels over two
    devices (the px mesh) of an unlit 120-cell run the chain."""
    scene = bench_scene("polytope_120cell", 61)
    before = pwf.shade_pack.launches
    pwf.frame_colors(scene, 256, 256, cuda, masks=True)
    monkeypatch.setattr(pwf, "render_devices", lambda device: [cuda] * 2)
    fmt = rgb8(256, 256)
    buf = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer().render(buf, fmt, scene)
    assert pwf.shade_pack.launches == before
