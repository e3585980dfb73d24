"""A frame's glue as CUDA graphs (``ntracer_tpu_torch.engine.graphs``) on
the CPU: which frames take the graphs, what their key holds, that the eager
path is the frame it was, and a frame's capture and replay under a stand-in
for CUDA graphs.

The stand-in (``FakeGraph``) records every aten op the glue runs while a
segment is captured, with the very tensors it read and wrote, and a replay
runs the ops again into the recorded outputs: the glue's static buffers, as
a CUDA graph keeps them.  An op that reads a device value on the host
(``.item()``, ``bool(t)``, ``nonzero``) fails the capture, as a sync does
on the card.  The walk wrappers take stand-in C entries (``_fake_kernel``)
that run the walks' plain twins, so a capture cuts its segments at the
launches and a replay calls them between the segments.  The card's
capture, replay and byte equality are ``tests/test_torch_graphs_gpu.py``'s.
"""

import contextlib
import threading
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

from ntracer_tpu_torch import BlockingRenderer, CallbackRenderer, tracing
from ntracer_tpu_torch.engine import graphs
from ntracer_tpu_torch.engine import grid_kernels as gk
from ntracer_tpu_torch.engine import resident_kernels as rk
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import (glass_scene, lit_scene, orthoplex_scene,
                            polytope_scene, random_scene, reflective_scene,
                            rgb8, solid_orthoplex_scene, solids_d4_scene)

CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")
SIDE = 32
WAIT = 120
# aten ops that hand a device value to the host
HOST_READS = ("aten::_local_scalar_dense", "aten::nonzero", "aten::item",
              "aten::is_nonzero", "aten::equal", "aten::masked_select")


# ---------------------------------------------------------------------------
# Which frames take the graphs, and their key
# ---------------------------------------------------------------------------

def test_eligible_only_single_card_walk_frames():
    plain = {"res_gt": None}
    assert graphs.eligible(CUDA, plain, None, False)
    # a CPU frame, a pool sharded over devices, the chunk scan, masks
    assert not graphs.eligible(CPU, plain, None, False)
    assert not graphs.eligible(CUDA, {"shards": []}, None, False)
    assert not graphs.eligible(CUDA, plain, None, True)
    assert not graphs.eligible(CUDA, plain, {}, False)


def test_frame_key_changes_with_every_field():
    scene = types.SimpleNamespace(_version=3)
    cfg = types.SimpleNamespace(shadows=False, camera_light=True,
                                max_reflect_depth=4, bg_axis=1)
    base = dict(scene=scene, cfg=cfg, device=CUDA, width=64, height=48,
                key=("fmt",), fov=(0.01, 32.0, 24.0), counters=False)
    first = graphs.frame_key(**base)
    assert first == graphs.frame_key(**base)
    changed = dict(
        scene=types.SimpleNamespace(_version=4),
        device=torch.device("cuda", 1), width=32, height=64, key=None,
        fov=(0.02, 32.0, 24.0), counters=True)
    for field, value in changed.items():
        assert graphs.frame_key(**dict(base, **{field: value})) != first, \
            field
    for flag, value in (("shadows", True), ("camera_light", False),
                        ("max_reflect_depth", 2), ("bg_axis", 0)):
        other = types.SimpleNamespace(**dict(vars(cfg), **{flag: value}))
        assert graphs.frame_key(**dict(base, cfg=other)) != first, flag


def test_scene_keeps_a_few_keys_and_drops_them_with_its_version():
    scene = types.SimpleNamespace(_version=0)
    entries = graphs._entries(scene)
    for k in range(graphs.MAX_KEYS + 2):
        graphs._keep(entries, k, graphs._WARM)
    assert list(graphs._entries(scene)) == list(
        range(2, graphs.MAX_KEYS + 2))
    scene._version = 1
    assert not graphs._entries(scene)


def test_eager_frame_is_the_composed_frame():
    """On the CPU the frame runs as it did: the composition of its camera,
    its scene's colors and its rays, bytes equal."""
    scene = polytope_scene()
    fmt = rgb8(SIDE, SIDE)
    key = pwf.packing.format_key(fmt)
    got = pwf._frame(scene, SIDE, SIDE, key, "cpu")
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    fov, cam_o, cam_t = pwf._camera(scene, SIDE, SIDE, "cpu")
    want = pwf._frame_packed_composite(
        arrs, cfg, pwf._scene_dyn(scene, "cpu"), cam_o, cam_t, fov,
        pwf._frame_groups(-(-(SIDE * SIDE) // pwf.TILE)), SIDE, key)
    assert torch.equal(got, want)
    assert getattr(scene, "_torch_graphs", None) is None


def test_frame_stats_report_the_graph_counters():
    stats = pwf.frame_stats(random_scene(3, n=200), SIDE, SIDE, "cpu")
    assert {k: stats[k] for k in graphs.COUNTERS} == dict.fromkeys(
        graphs.COUNTERS, 0)
    assert stats["rays_traced"] > 0


# ---------------------------------------------------------------------------
# A stand-in for CUDA graphs
# ---------------------------------------------------------------------------

class _Record(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._schema.name in HOST_READS:
            raise RuntimeError(f"{func._schema.name} reads a device value "
                               "on the host while a frame is captured")
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class FakeGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: capture records the aten ops
    (which also run), replay runs them again into the recorded outputs."""

    captures = 0

    def __init__(self):
        self.ops = []
        self.mode = None

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        FakeGraph.captures += 1
        self.mode = _Record(self.ops)
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)

    def replay(self):
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            for o, n in zip(tree_flatten(out)[0], tree_flatten(new)[0]):
                if isinstance(o, torch.Tensor) and \
                        o.untyped_storage().data_ptr() != \
                        n.untyped_storage().data_ptr():
                    o.copy_(n)


def _twin(kind, w):
    """The walk's plain twin on the walk inputs ``w``, outside any
    capture; outputs as the C entry's wrapper returns them."""
    with _disable_current_modes():
        if kind == "nearest":
            return rk._walk_ref(w)
        if kind == "grid":
            return gk._grid_ref(w)
        blocked, filt, vis = rk._occlusion_ref(w)
        return (blocked, vis) if w["opa"] is None else (blocked, filt, vis)


def _fake_kernel(kind):
    """A walk's C launch whose entry runs its twin into the outputs."""
    def kernel(*a):
        w, dev, then = (a[1], a[2], a[3]) if kind != "grid" \
            else (a[0], a[2], a[3])
        with _disable_current_modes():
            outs = [t.clone() for t in _twin(kind, w)]

        def entry(_stream):
            got = _twin(kind, w)
            with _disable_current_modes():
                for o, n in zip(outs, got):
                    o.copy_(n)
            return 0

        return graphs.launch(entry, (), dev, (w,), then), tuple(outs)
    return kernel


@pytest.fixture
def fake_graphs(monkeypatch):
    """CUDA graphs on the CPU: the stand-ins, the walk wrappers on their
    stand-in C entries, and CPU frames eligible."""
    FakeGraph.captures = 0
    stream = types.SimpleNamespace(cuda_stream=0)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 0))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(rk, "_device", lambda name, dev: True)
    monkeypatch.setattr(rk, "_nearest_kernel", _fake_kernel("nearest"))
    monkeypatch.setattr(rk, "_occlusion_kernel", _fake_kernel("occlusion"))
    monkeypatch.setattr(gk, "_grid_kernel", _fake_kernel("grid"))
    real = graphs.eligible
    monkeypatch.setattr(graphs, "eligible",
                        lambda device, arrs, masks, scan: real(
                            CUDA, arrs, masks, scan))
    return monkeypatch


def _turn(scene, k):
    """The camera turned about the world origin in the plane of axes 0 and
    2 by 0.04 k radians."""
    cam = scene.get_camera()
    d = cam.dimension
    r = np.eye(d)
    c, s = np.cos(0.04 * k), np.sin(0.04 * k)
    r[0, 0], r[0, 2], r[2, 0], r[2, 2] = c, -s, s, c
    cam._origin = (r @ cam._origin).astype(np.float32)
    cam._t = (cam._t @ r.T).astype(np.float32)
    scene.set_camera(cam)


def _frames(scene, n, fmt, renderer=None):
    renderer = renderer or BlockingRenderer(device="cpu")
    base = scene.get_camera()
    out = []
    for k in range(n):
        scene.set_camera(base)
        _turn(scene, k)
        buf = bytearray(fmt.pitch * fmt.height)
        assert renderer.render(buf, fmt, scene)
        out.append(bytes(buf))
    scene.set_camera(base)
    return out


def _launches():
    return sum(fn.launches for fn in (
        rk.nearest_hit, rk.occluded, rk.nearest_hit_transparent,
        rk.nearest_hit_transparent_hbm, rk.occluded_transparent,
        gk.nearest_hit, gk.occluded))


SCENES = {
    "polytope": lambda: polytope_scene(symbol=(5, 3, 3)),
    "streaming": lambda: random_scene(3, n=1200),
    "lit_d6": lambda: lit_scene(6),
    "glass": lambda: glass_scene(lit=True),
    "reflective": lambda: reflective_scene(shadows=True),
    "orthoplex_d10": lambda: orthoplex_scene(10, companion="shade"),
    "solids_d4": solids_d4_scene,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_replayed_frames_equal_eager_frames(name, fake_graphs):
    """Three frames with the camera moving: the first eager, the second
    captured and replayed, the third replayed, bytes equal to eager frames;
    each walk launched once a frame."""
    fake_graphs.setattr(pwf, "TILE", 1024)
    if name == "streaming":
        fake_graphs.setattr(rk, "STREAM_POOL_BYTES", 1024)
    scene = SCENES[name]()
    fmt = rgb8(SIDE, SIDE)
    first = _launches()
    with fake_graphs.context() as m:
        m.setattr(graphs, "eligible", lambda *a: False)
        eager = _frames(scene, 3, fmt)
    assert getattr(scene, "_torch_graphs", None) is None
    if name == "streaming":
        assert pwf._streams(pwf.get_device_scene(scene, "cpu")[1])
    mid = _launches()
    assert _frames(scene, 3, fmt) == eager
    # the walks launch as often as eagerly
    assert _launches() - mid == mid - first > 0
    (entry,) = graphs._entries(scene).values()
    assert len(entry.graphs) == len(entry.calls) + 1 >= 2
    assert FakeGraph.captures == len(entry.graphs)


def test_counters_and_spans_of_replayed_frames(fake_graphs):
    """``frame_stats`` of replayed frames equal the eager frame's, with
    the graph counters set; a traced replayed frame's spans are the camera,
    the segments and the walks between them."""
    fake_graphs.setattr(pwf, "TILE", 1024)
    scene = reflective_scene(shadows=True)
    stats = [pwf.frame_stats(scene, SIDE, SIDE, "cpu") for _ in range(3)]
    counters = [{k: s.pop(k) for k in graphs.COUNTERS} for s in stats]
    assert stats[0] == stats[1] == stats[2]
    assert stats[0]["shadow_rays"] > 0
    assert counters == [
        dict(glue_graph_replays=0, glue_graph_captures=0),
        dict(glue_graph_replays=1, glue_graph_captures=1),
        dict(glue_graph_replays=1, glue_graph_captures=0)]

    tracing.drain()
    tracing.enable()
    try:
        fmt = rgb8(SIDE, SIDE)
        _frames(scene, 3, fmt)
    finally:
        tracing.disable()
    rec = tracing.drain()
    frames = sorted(rec["counters"])
    assert [rec["counters"][f]["glue_graph_replays"] for f in frames] == \
        [0, 1, 1]
    assert [rec["counters"][f]["glue_graph_captures"] for f in frames] == \
        [0, 1, 0]
    assert rec["counters"][frames[1]]["chunks_visited"] == \
        rec["counters"][frames[0]]["chunks_visited"] > 0
    last = sorted((s for s in rec["spans"] if s["frame"] == frames[-1]
                   and s["name"].startswith("dispatch.")),
                  key=lambda s: s["start"])
    names = [s["name"] for s in last]
    assert "dispatch.shade" not in names and "dispatch.capture" not in names
    segs = [s["attrs"]["seg"] for s in last if s["name"] == "dispatch.graph"]
    walks = [n for n in names if n in ("dispatch.walk", "dispatch.occlusion")]
    assert segs == list(range(len(walks) + 1)) and walks
    chain = [n for n in names if n != "dispatch.camera"]
    assert chain[0::2] == ["dispatch.graph"] * len(segs)
    capture = [s["name"] for s in rec["spans"] if s["frame"] == frames[1]]
    assert "dispatch.capture" in capture and "dispatch.shade" in capture


def test_a_new_version_recaptures(fake_graphs):
    """A change of fov or background between replays shows in the next
    frame (a new version: one eager frame, then a capture), as it does
    eagerly."""
    fake_graphs.setattr(pwf, "TILE", 1024)
    fmt = rgb8(SIDE, SIDE)

    def run(scene):
        out = _frames(scene, 3, fmt)
        scene.set_fov(0.6)
        out += _frames(scene, 3, fmt)
        scene.set_background((0.2, 0.3, 0.4), (0.1, 0.1, 0.1),
                             (0.5, 0.2, 0.1), 0)
        return out + _frames(scene, 3, fmt)

    with fake_graphs.context() as m:
        m.setattr(graphs, "eligible", lambda *a: False)
        eager = run(polytope_scene())
    FakeGraph.captures = 0
    scene = polytope_scene()
    got = run(scene)
    assert got == eager
    assert got[2] != got[5] != got[8]
    # one capture of (segments) a version
    (entry,) = graphs._entries(scene).values()
    assert FakeGraph.captures == 3 * len(entry.graphs)


def test_callback_frames_in_flight_keep_their_bytes(fake_graphs):
    """Frames begun one after another, their pulls behind: each buffer
    receives its own frame's bytes."""
    fake_graphs.setattr(pwf, "TILE", 1024)
    fmt = rgb8(SIDE, SIDE)
    scene = polytope_scene()
    base = scene.get_camera()
    with fake_graphs.context() as m:
        m.setattr(graphs, "eligible", lambda *a: False)
        eager = _frames(scene, 6, fmt)
    done = threading.Semaphore(0)
    r = CallbackRenderer(device="cpu")
    bufs = [bytearray(fmt.pitch * fmt.height) for _ in range(6)]
    for k, buf in enumerate(bufs):
        scene.set_camera(base)
        _turn(scene, k)
        r.begin_render(buf, fmt, scene, lambda _r: done.release())
    assert all(done.acquire(timeout=WAIT) for _ in bufs)
    assert [bytes(b) for b in bufs] == eager
    assert graphs._entries(scene)


def test_capture_fails_on_a_host_read(fake_graphs):
    """The chunk scan reads device values on the host: captured, it fails,
    which is why ``eligible`` keeps it eager."""
    scene = solid_orthoplex_scene(10, glass=True)
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    assert pwf._scan(arrs)
    R = rk.RAY_BLOCK
    oT = torch.zeros((cfg.d, R))
    oT[2] = -4
    dT = torch.zeros((cfg.d, R))
    dT[2] = 1
    skip = torch.full((R,), -1, dtype=torch.int32)
    graph = FakeGraph()
    graph.capture_begin(capture_error_mode="thread_local")
    try:
        with pytest.raises(RuntimeError, match="reads a device value"):
            pwf.trace_scan(arrs, cfg, oT, dT, skip)
    finally:
        graph.capture_end()
