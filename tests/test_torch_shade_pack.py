"""The frame's post-walk glue as one kernel (``wavefront.shade_pack``) on
the CPU: which frames take it (the counter ``glue_fused``), its plain
version against the chain it replaces (``_ray_colors_T`` and
``packing.pack_device_stream``) byte for byte, the pixel placement rule of
its CUDA kernel (``csrc/shade_pack.cu``) against the frame's unswizzle, and
its replayed frames under the CPU stand-in for CUDA graphs.  No module here
imports JAX; the card's side is ``test_torch_shade_pack_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ntracer_tpu_torch import BlockingRenderer, tracing
from ntracer_tpu_torch.engine import graphs
from ntracer_tpu_torch.engine import packing
from ntracer_tpu_torch.engine import shade_pack as sp
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import (api, bench_scene, formats, glass_scene,
                            lit_scene_3d, polytope_scene, random_scene, rgb8,
                            solids_d4_scene, unlit_reflective_scene,
                            wide_d17_scene)
from test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)

SIDE = 32

# opaque unlit scenes the kernel takes, by dimension
FUSED = {
    3: lambda: random_scene(3, n=300),
    4: lambda: polytope_scene(),
    10: lambda: bench_scene("polytope_orthoplex_d10", 61),
}


def _wide_format(w, h):
    a = api()
    return a.ImageFormat(w, h, [a.Channel(30, 1, 0, 0), a.Channel(30, 0, 1, 0),
                                a.Channel(4, 0, 0, 1)])


def _counters(scene, fmt):
    """The counters of one frame of ``scene`` through ``BlockingRenderer``
    on the CPU (tracing on)."""
    tracing.drain()
    tracing.enable()
    try:
        buf = bytearray(fmt.pitch * fmt.height)
        assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
    finally:
        tracing.disable()
    (counters,) = tracing.drain()["counters"].values()
    return counters


def _chain(scene, w, h, key):
    """The frame through the chain: ``_frame_packed_composite`` without
    ``fused``."""
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    fov, cam_o, cam_t = pwf._camera(scene, w, h, "cpu")
    return pwf._frame_packed_composite(
        arrs, cfg, pwf._scene_dyn(scene, "cpu"), cam_o, cam_t, fov,
        pwf._frame_groups(-(-(w * h) // pwf.TILE)), w, key)


@pytest.mark.parametrize("d", sorted(FUSED))
def test_opaque_unlit_frames_take_the_kernel(d):
    scene = FUSED[d]()
    assert _counters(scene, rgb8(SIDE, SIDE))["glue_fused"] == 1
    key = packing.format_key(rgb8(SIDE, SIDE))
    before = pwf.shade_pack.launches
    stats = {}
    got = pwf._frame(scene, SIDE, SIDE, key, "cpu", stats=stats)
    assert stats["glue_fused"] == 1 and stats["rays_traced"] == pwf.TILE
    # on the CPU the plain version runs: no launch
    assert pwf.shade_pack.launches == before
    assert torch.equal(got, _chain(scene, SIDE, SIDE, key))


# frames the kernel does not take: (scene maker, format)
CHAIN = {
    "lit": (lit_scene_3d, rgb8),
    "glass": (lambda: glass_scene(300), rgb8),
    "solid": (solids_d4_scene, rgb8),
    "reflective": (unlit_reflective_scene, rgb8),
    "d17": (wide_d17_scene, rgb8),
    "wide_format": (lambda: random_scene(3, n=300), _wide_format),
}


@pytest.mark.parametrize("name", sorted(CHAIN))
def test_other_frames_run_the_chain(name):
    make, fmt = CHAIN[name]
    scene = make()
    fmt = fmt(SIDE, SIDE)
    assert _counters(scene, fmt)["glue_fused"] == 0
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    assert not pwf._glue_fused(arrs, cfg, packing.format_key(fmt))
    key = None if pwf._needs_host_pack(fmt) else packing.format_key(fmt)
    stats = {}
    got = pwf._frame(scene, SIDE, SIDE, key, "cpu", stats=stats)
    assert stats["glue_fused"] == 0
    assert torch.equal(got, _chain(scene, SIDE, SIDE, key))


def test_what_each_rule_refuses():
    """Each condition of ``_glue_fused`` alone refuses an eligible frame;
    diagnostic masks and a missing key (float colors) refuse it in
    ``_frame``."""
    scene = FUSED[4]()
    key = packing.format_key(rgb8(SIDE, SIDE))
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    assert pwf._glue_fused(arrs, cfg, key)
    for change in (dict(has_transparency=True), dict(n_solids=1),
                   dict(n_point_lights=1), dict(n_global_lights=1),
                   dict(has_reflectivity=True, max_reflect_depth=1),
                   dict(d=2), dict(d=17)):
        assert not pwf._glue_fused(arrs, dataclasses.replace(cfg, **change),
                                   key), change
    # a reflective material with no bounce left takes it
    assert pwf._glue_fused(arrs, dataclasses.replace(
        cfg, has_reflectivity=True, max_reflect_depth=0), key)
    assert not pwf._glue_fused(dict(arrs, shards=[]), cfg, key)
    assert not pwf._glue_fused(arrs, cfg, None)
    assert not pwf._glue_fused(arrs, cfg, packing.format_key(
        _wide_format(SIDE, SIDE)))
    for masks, k in (({}, key), (None, None)):
        stats = {}
        pwf._frame(scene, SIDE, SIDE, k, "cpu", masks=masks, stats=stats)
        assert stats["glue_fused"] == 0


# (width, height, TILE): one tiled group, one untiled group, four tiled
# groups in one run, two runs (tiled and not), two untiled runs
SIZES = [(64, 48, None), (40, 30, None), (128, 128, 1024), (96, 112, 1024),
         (100, 90, 1024)]
FORMATS = ["rgb8", "rgb48", "bgra_reversed", "float", "rgb565"]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("d", [3, 4])
def test_plain_version_is_the_chain(d, size, monkeypatch):
    w, h, tile = size
    if tile:
        monkeypatch.setattr(pwf, "TILE", tile)
    scene = FUSED[d]()
    for name in FORMATS:
        key = packing.format_key(formats(w, h)[name])
        got = pwf._frame(scene, w, h, key, "cpu")
        assert torch.equal(got, _chain(scene, w, h, key)), name


@pytest.mark.parametrize("name", ["rgb48", "bgra_reversed", "float"])
def test_plain_version_is_the_chain_at_d10(name, monkeypatch):
    monkeypatch.setattr(pwf, "TILE", 1024)
    scene = FUSED[10]()
    w, h = 96, 112
    key = packing.format_key(formats(w, h)[name])
    assert torch.equal(pwf._frame(scene, w, h, key, "cpu"),
                       _chain(scene, w, h, key))


def kernel_pixels(runs, w, tile_w, tile_h, R):
    """``linear_pixel`` of csrc/shade_pack.cu in numpy: the linear pixel of
    each of the frame's R rays from its run of groups (``_group_runs``)."""
    r = np.arange(R)
    q = np.zeros(R, np.int64)
    for i in range(1, len(runs)):
        q += r >= runs[i][0]
    first = np.array([f for f, _c, _n, _s in runs])[q]
    count = np.array([c for _f, c, _n, _s in runs])[q]
    swz = np.array([s for *_x, s in runs], bool)[q]
    start = first + (r - first) // count * count
    j = r - start
    per_tile = tile_w * tile_h
    tile, within = j // per_tile, j % per_tile
    tpr = w // tile_w
    x = tile % tpr * tile_w + within % tile_w
    y = tile // tpr * tile_h + within // tile_w
    return np.where(swz, start + y * w + x, r)


@pytest.mark.parametrize("size", SIZES + [(1920, 1080, None),
                                          (1024, 1024, None),
                                          (1000, 700, None)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_places_pixels_as_the_unswizzle(size, monkeypatch):
    """The kernel writes ray i's pixel where the frame's unswizzle
    (``_frame_coords``) puts it, on the benchmark's frames too (1920x1080
    is one untiled run of four groups, 1024x1024 four tiled groups)."""
    w, h, tile = size
    if tile:
        monkeypatch.setattr(pwf, "TILE", tile)
    groups = pwf._frame_groups(-(-(w * h) // pwf.TILE))
    runs = pwf._group_runs(groups, w)
    assert len(runs) <= sp.MAX_RUNS
    R = sum(c for _s, c in groups)
    _xs, _ys, unswz = pwf._frame_coords(groups, w, "cpu")
    order = unswz(torch.arange(R)).numpy()         # linear pixel -> ray
    lin = kernel_pixels(runs, w, pwf.TILE_W, pwf.TILE_H, R)
    np.testing.assert_array_equal(lin[order], np.arange(R))


def test_launch_refuses_what_the_kernel_does_not_take():
    scene = FUSED[3]()
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    dyn = pwf._scene_dyn(scene, "cpu")
    key = packing.format_key(rgb8(SIDE, SIDE))
    R = 1024
    slot = torch.full((R,), -1, dtype=torch.int32)
    args = (slot, False, arrs["res_slot_pack"], arrs, cfg, dyn)
    with pytest.raises(ValueError):
        sp.launch(*args, torch.zeros(17), torch.zeros((17, R)), key,
                  [(0, R, 1, 0)], SIDE, 32, 16, None)
    with pytest.raises(ValueError):
        sp.launch(*args, torch.zeros(3), torch.zeros((3, R)), key,
                  [(0, 512, 1, 0)], SIDE, 32, 16, None)
    with pytest.raises(ValueError):
        sp.on_card(torch.device("meta"))
    assert not sp.on_card(torch.device("cpu"))


def test_replayed_frames_count_the_kernel(fake_graphs):  # noqa: F811
    """Under the CPU stand-in for CUDA graphs: the eager frame, the captured
    one and a replayed one each count ``glue_fused``, the capture cuts at
    the one walk launch (two segments), and the bytes are the chain's."""
    fake_graphs.setattr(pwf, "TILE", 1024)
    scene = FUSED[4]()
    key = packing.format_key(rgb8(SIDE, SIDE))
    got = []
    for _ in range(3):
        stats = {}
        got.append(pwf._frame(scene, SIDE, SIDE, key, "cpu", stats=stats))
        assert stats["glue_fused"] == 1
    assert stats["glue_graph_replays"] == 1
    (entry,) = graphs._entries(scene).values()
    assert len(entry.calls) == 1 and len(entry.graphs) == 2
    want = _chain(scene, SIDE, SIDE, key)
    assert all(torch.equal(g, want) for g in got)
