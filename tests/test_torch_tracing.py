"""The port's spans and per-frame counters (``ntracer_tpu_torch.tracing``):
nothing recorded and nothing counted while off; while on, a frame's span
tree with one frame id, the frame's counters equal to ``frame_stats``,
CallbackRenderer frames whose pull and callback spans carry their
dispatch's id on the worker's thread, the set-up's spans, and ``drain``."""

import threading

import pytest
import torch

from ntracer_tpu_torch import (BlockingRenderer, CallbackRenderer, Channel,
                               ImageFormat, NTracer, tracing)
from ntracer_tpu_torch.engine import wavefront as pwf
from ntracer_tpu_torch.wavefront_obj import load_obj

from _torch_helpers import glass_scene, random_scene, reflective_scene, rgb8

WAIT = 120
SIDE = 32

# child span -> the span it is opened in (BlockingRenderer, one device)
PARENT = {
    "frame.dispatch": "frame.render",
    "dispatch.camera": "frame.dispatch",
    "dispatch.primary_ctx": "frame.dispatch",
    "dispatch.raygen": "frame.dispatch",
    "dispatch.walk": "frame.dispatch",
    "dispatch.shade": "frame.dispatch",
    "dispatch.occlusion": "dispatch.shade",
    "dispatch.pack": "frame.dispatch",
    "frame.pull": "frame.render",
    "pull.wait": "frame.pull",
    "pull.pack": "frame.pull",
    "pull.write": "frame.pull",
}


def wide_format(w, h):
    """30-bit channels: colors cross as floats and are packed on the host
    (``pull.pack``)."""
    return ImageFormat(w, h, [Channel(30, 1, 0, 0), Channel(30, 0, 1, 0),
                              Channel(30, 0, 0, 1)])


@pytest.fixture
def traced():
    """Tracing on for the test, off and empty after it."""
    tracing.drain()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


def _lit_reflective():
    scene = reflective_scene(shadows=True)
    pwf.get_device_scene(scene, "cpu")
    return scene


def _callback_frames(scene, fmt, n):
    """``n`` CallbackRenderer frames in flight; returns the worker's thread
    id as each callback saw it."""
    cr = CallbackRenderer(device="cpu")
    bufs = [bytearray(fmt.pitch * fmt.height) for _ in range(n)]
    seen = []
    done = threading.Event()

    def cb(_r):
        seen.append(threading.get_ident())
        if len(seen) == n:
            done.set()

    for k in range(n):
        cr.begin_render(bufs[k], fmt, scene, cb)
    assert done.wait(timeout=WAIT)
    cr.abort_render()
    return seen


@pytest.mark.parametrize("renderer", ["blocking", "callback"])
def test_off_records_and_counts_nothing(renderer, monkeypatch):
    scene = _lit_reflective()
    fmt = rgb8(SIDE, SIDE)
    tracing.drain()
    assert not tracing.enabled()
    assert tracing.span("frame.render") is tracing.span("x", depth=1) \
        is tracing.OFF
    assert tracing.now() is None and tracing.new_frame() is None

    def no_clock():
        raise AssertionError("the clock was read while tracing is off")

    counted = []
    real_stat = pwf._stat

    def spy(stats, key, count):
        real_stat(stats, key, lambda: (counted.append(key), count())[1])

    monkeypatch.setattr(tracing, "clock", no_clock)
    monkeypatch.setattr(pwf, "_stat", spy)
    if renderer == "blocking":
        buf = bytearray(fmt.pitch * fmt.height)
        assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
    else:
        _callback_frames(scene, fmt, 2)
    assert counted == []
    assert tracing.drain() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("fmt", [rgb8, wide_format])
def test_blocking_frame_span_tree(fmt, traced):
    scene = _lit_reflective()
    fmt = fmt(SIDE, SIDE)
    tracing.drain()
    buf = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
    spans = tracing.drain()["spans"]
    by_id = {s["id"]: s for s in spans}
    names = {s["name"] for s in spans}
    # a wide format packs on the host (``pull.pack``), others on the
    # device (``dispatch.pack``)
    wide = any(c.bit_size > 23 for c in fmt.channels)
    assert names == ({"frame.render"} | set(PARENT)) - (
        {"dispatch.pack"} if wide else {"pull.pack"})
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "frame.render" and root["frame"] is not None
    for s in spans:
        assert s["frame"] == root["frame"], s
        assert s["thread"] == root["thread"]
        assert s["start"] <= s["end"]
        if s is root:
            continue
        parent = by_id[s["parent"]]
        assert parent["name"] == PARENT[s["name"]], s
        assert parent["start"] <= s["start"] and s["end"] <= parent["end"]
    # the bounce loop: one walk and one shade a depth, each shade's
    # shadow queries (a point and a global light) inside it
    depth = scene.max_reflect_depth
    walks = [s["attrs"]["depth"] for s in spans if s["name"] ==
             "dispatch.walk"]
    assert walks == list(range(depth + 1))
    assert sum(s["name"] == "dispatch.occlusion" for s in spans) == \
        2 * (depth + 1)


@pytest.mark.parametrize("make", [_lit_reflective,
                                  lambda: glass_scene(300, lit=True)],
                         ids=["lit_reflective", "lit_glass"])
def test_frame_counters_equal_frame_stats(make, traced):
    scene = make()
    pwf.get_device_scene(scene, "cpu")
    fmt = rgb8(SIDE, SIDE)
    tracing.drain()
    buf = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
    rec = tracing.drain()
    (frame,) = {s["frame"] for s in rec["spans"]}
    assert set(rec["counters"]) == {frame}
    tracing.disable()
    assert rec["counters"][frame] == pwf.frame_stats(scene, SIDE, SIDE, "cpu")
    assert rec["counters"][frame]["chunks_visited"] > 0


def test_callback_frames_keep_their_ids(traced):
    scene = _lit_reflective()
    fmt = rgb8(SIDE, SIDE)
    tracing.drain()
    caller = threading.get_ident()
    seen = _callback_frames(scene, fmt, 3)
    rec = tracing.drain()
    spans = rec["spans"]
    begins = sorted((s for s in spans if s["name"] == "frame.begin"),
                    key=lambda s: s["start"])
    frames = [s["frame"] for s in begins]
    assert len(set(frames)) == 3 and None not in frames
    assert all(s["thread"] == caller for s in begins)
    dispatch = {s["frame"]: s for s in spans if s["name"] == "frame.dispatch"}
    assert sorted(dispatch) == sorted(frames)
    for f in frames:
        assert dispatch[f]["parent"] == [s for s in begins
                                         if s["frame"] == f][0]["id"]
    worker = set(seen)
    assert len(worker) == 1 and caller not in worker
    for name in ("frame.queue", "frame.pull", "pull.wait", "pull.write",
                 "frame.callback"):
        got = sorted((s for s in spans if s["name"] == name),
                     key=lambda s: s["start"])
        # one a frame, in the order the frames were begun (FIFO)
        assert [s["frame"] for s in got] == frames, name
        assert {s["thread"] for s in got} == worker, name
    for s in spans:
        if s["name"] == "frame.queue":
            assert dispatch[s["frame"]]["end"] <= s["start"]
    assert sorted(rec["counters"]) == sorted(frames)


def test_drain_clears(traced):
    scene = _lit_reflective()
    fmt = rgb8(SIDE, SIDE)
    tracing.drain()
    buf = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
    first = tracing.drain()
    assert first["spans"] and first["counters"]
    assert tracing.drain() == {"spans": [], "counters": {}}
    # a later frame draws a new id
    assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
    later = tracing.drain()
    assert {s["frame"] for s in later["spans"]}.isdisjoint(
        {s["frame"] for s in first["spans"]})


def test_setup_spans(tmp_path, traced):
    """The OBJ load, the k-d build and the device scene (on a cache miss
    only), outside any frame."""
    path = tmp_path / "quad.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    nt = NTracer(3)
    protos = load_obj(str(path), nt)
    scene = nt.build_composite_scene(protos)
    pwf.get_device_scene(scene, "cpu")
    pwf.get_device_scene(scene, "cpu")
    spans = tracing.drain()["spans"]
    by_id = {s["id"]: s for s in spans}
    assert [s["name"] for s in spans if s["parent"] is None] == [
        "scene.load_obj", "scene.kd_build", "scene.device"]
    (dev,) = [s for s in spans if s["name"] == "scene.device"]
    assert dev["attrs"] == {"cached": False}
    assert sorted(by_id[s["parent"]]["name"] for s in spans
                  if s["name"] in ("scene.flatten", "scene.upload")) == [
        "scene.device"] * 2
    assert all(s["frame"] is None for s in spans)


def test_sharded_frame_spans(monkeypatch, traced):
    """A frame split over two devices (the px mesh) records the same
    spans through the shared functions: a walk and a pack a shard."""
    scene = random_scene(3, n=60, seed=5)
    fmt = rgb8(64, 64)
    monkeypatch.setattr(pwf, "render_devices",
                        lambda device: [torch.device("cpu")] * 2)
    buf = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
    spans = tracing.drain()["spans"]
    (frame,) = {s["frame"] for s in spans
                if not s["name"].startswith("scene.")}
    count = {n: sum(s["name"] == n for s in spans) for n in PARENT}
    assert count["frame.dispatch"] == 1 and count["frame.pull"] == 1
    assert count["dispatch.walk"] == 2 and count["dispatch.pack"] == 2
    assert count["pull.wait"] == 2 and frame is not None
