"""A frame's glue as CUDA graphs on the card (``engine/graphs.py``): graphed
frames equal eager frames byte for byte over a moving camera on the main
path's scene classes, a changed fov or background shows in the next frame,
a new scene version captures again, frames in flight keep their own bytes,
and ``frame_stats`` counts what the eager frame counts.  Every test here is
marked ``gpu`` and skips without a card; the file imports no jax:

    python -m pytest -m gpu --noconftest -p no:cacheprovider \\
        tests/test_torch_graphs_gpu.py
"""

import threading

import numpy as np
import pytest
import torch

from ntracer_tpu_torch import BlockingRenderer, CallbackRenderer, tracing
from ntracer_tpu_torch.engine import graphs
from ntracer_tpu_torch.engine import grid_kernels as gk
from ntracer_tpu_torch.engine import resident_kernels as prk
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import (_smoke, api, orthoplex_scene,
                            polytope_scene, random_scene, reflective_scene,
                            rgb8, solids_d4_scene)

pytestmark = pytest.mark.gpu
SIDE = 256
FRAMES = 3
WAIT = 120


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lit_config():
    a = api()
    return _smoke().lit_scene(a.NTracer(6), a.Material)[0]


# the main path's scene classes: (scene maker, frame side, pool over the line)
SCENES = {
    "flagship_120cell": (lambda: polytope_scene(symbol=(5, 3, 3)), 1024,
                         False),
    "streaming_mesh": (lambda: random_scene(3, n=1200), SIDE, True),
    "lit_config_d6": (_lit_config, SIDE, False),
    "glass_120cell": (lambda: polytope_scene(symbol=(5, 3, 3), glass=True,
                                             lit=True), SIDE, False),
    "reflective": (lambda: reflective_scene(shadows=True), SIDE, False),
    "orthoplex_d10": (lambda: orthoplex_scene(10, reflectivity=0.3,
                                              companion="floor"), SIDE,
                      False),
    "solids_d4": (solids_d4_scene, SIDE, False),
}


def _turn(scene, k):
    """The camera turned about the world origin in the plane of axes 0 and
    2 by 0.04 k radians."""
    cam = scene.get_camera()
    r = np.eye(cam.dimension)
    c, s = np.cos(0.04 * k), np.sin(0.04 * k)
    r[0, 0], r[0, 2], r[2, 0], r[2, 2] = c, -s, s, c
    cam._origin = (r @ cam._origin).astype(np.float32)
    cam._t = (cam._t @ r.T).astype(np.float32)
    scene.set_camera(cam)


def _frames(scene, fmt, n=FRAMES):
    """``n`` BlockingRenderer frames, the camera turned a step before each;
    the scene's camera is left as it was."""
    base = scene.get_camera()
    out = []
    for k in range(n):
        scene.set_camera(base)
        _turn(scene, k)
        buf = bytearray(fmt.pitch * fmt.height)
        assert BlockingRenderer().render(buf, fmt, scene)
        out.append(bytes(buf))
    scene.set_camera(base)
    return out


def _eager(monkeypatch, scene, fmt, n=FRAMES):
    with monkeypatch.context() as m:
        m.setattr(graphs, "eligible", lambda *a: False)
        return _frames(scene, fmt, n)


def _launches():
    return sum(fn.launches for fn in (
        prk.nearest_hit, prk.nearest_hit_hbm, prk.occluded,
        prk.occluded_hbm, prk.nearest_hit_transparent,
        prk.nearest_hit_transparent_hbm, prk.occluded_transparent,
        prk.occluded_transparent_hbm, gk.nearest_hit, gk.occluded))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_graphed_frames_equal_eager_frames(cuda, name, monkeypatch):
    """Three frames, the camera moving: the first eager, the second
    captured and replayed, the third replayed; bytes equal to the eager
    frames', the walks launched as often."""
    make, side, streams = SCENES[name]
    if streams:
        monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    scene = make()
    fmt = rgb8(side, side)
    first = _launches()
    eager = _eager(monkeypatch, scene, fmt)
    mid = _launches()
    assert getattr(scene, "_torch_graphs", None) is None
    assert pwf._streams(pwf.get_device_scene(scene, cuda)[1]) == streams
    got = _frames(scene, fmt)
    torch.cuda.synchronize()
    assert _launches() - mid == mid - first > 0
    assert got == eager
    assert any(np.frombuffer(b, np.uint8).any() for b in got)
    (entry,) = graphs._entries(scene).values()
    assert len(entry.graphs) == len(entry.calls) + 1 >= 2


def test_changed_fov_and_background_show_in_the_next_frame(cuda,
                                                           monkeypatch):
    scene = polytope_scene(symbol=(5, 3, 3))
    fmt = rgb8(SIDE, SIDE)

    def run():
        out = _frames(scene, fmt)
        scene.set_fov(0.6)
        out += _frames(scene, fmt)
        scene.set_background((0.2, 0.3, 0.4), (0.1, 0.1, 0.1),
                             (0.5, 0.2, 0.1), 0)
        out += _frames(scene, fmt)
        scene.set_fov(0.8)
        scene.set_background((1, 1, 1), (0, 0, 0), (0, 1, 1), 1)
        return out

    with monkeypatch.context() as m:
        m.setattr(graphs, "eligible", lambda *a: False)
        eager = run()
    got = run()
    assert got == eager
    assert got[2] != got[5] != got[8]


def test_a_new_version_captures_again(cuda):
    """``frame_stats`` of one key: eager, captured, replayed; after a new
    version the same again.  The counters equal the eager frame's."""
    scene = reflective_scene(shadows=True)
    got = []
    for fov in (0.8, 0.7):
        scene.set_fov(fov)
        got += [pwf.frame_stats(scene, SIDE, SIDE, cuda) for _ in range(3)]
    flags = [tuple(s.pop(k) for k in graphs.COUNTERS) for s in got]
    assert flags == [(0, 0), (1, 1), (1, 0)] * 2
    assert got[0] == got[1] == got[2] and got[3] == got[4] == got[5]
    assert got[0]["chunks_visited"] > 0 and got[0]["shadow_rays"] > 0


def test_traced_frames_replay_with_their_spans(cuda):
    """With tracing on, every frame after the capture replays; its spans
    are the segments with the walks' launches between them."""
    scene = polytope_scene(symbol=(5, 3, 3))
    fmt = rgb8(SIDE, SIDE)
    tracing.drain()
    tracing.enable()
    try:
        _frames(scene, fmt, 5)
    finally:
        tracing.disable()
    rec = tracing.drain()
    frames = sorted(rec["counters"])
    assert [rec["counters"][f]["glue_graph_replays"] for f in frames] == \
        [0, 1, 1, 1, 1]
    assert [rec["counters"][f]["glue_graph_captures"] for f in frames] == \
        [0, 1, 0, 0, 0]
    visits = {rec["counters"][f]["chunks_visited"] for f in frames}
    assert min(visits) > 0
    last = [s["name"] for s in sorted(rec["spans"], key=lambda s: s["start"])
            if s["frame"] == frames[-1] and s["name"] in (
                "dispatch.graph", "dispatch.walk")]
    assert last == ["dispatch.graph", "dispatch.walk", "dispatch.graph"]


def test_profiler_sees_each_replayed_walk_launch(cuda):
    """The walk kernel is launched eagerly between the graphs: a profiled
    run of replayed frames shows it by name once a frame, beside the
    graphs' kernels."""
    from torch.profiler import ProfilerActivity, profile
    scene = polytope_scene(symbol=(5, 3, 3))
    fmt = rgb8(SIDE, SIDE)
    _frames(scene, fmt, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _frames(scene, fmt, 3)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    walks = [n for n in ops if "nearest_stream_kernel" in n]
    print(f"{len(walks)} walk kernels among {len(ops)} device operations")
    assert len(walks) == 3
    assert len(ops) > 10 * len(walks)


def test_callback_frames_in_flight_keep_their_bytes(cuda, monkeypatch):
    """Six frames begun one after another, the camera turned after each
    dispatch: each buffer holds the eager frame of its camera."""
    scene = polytope_scene(symbol=(5, 3, 3))
    fmt = rgb8(SIDE, SIDE)
    eager = _eager(monkeypatch, scene, fmt, 6)
    _frames(scene, fmt, 2)
    base = scene.get_camera()
    done = threading.Semaphore(0)
    r = CallbackRenderer()
    bufs = [bytearray(fmt.pitch * fmt.height) for _ in range(6)]
    for k, buf in enumerate(bufs):
        scene.set_camera(base)
        _turn(scene, k)
        r.begin_render(buf, fmt, scene, lambda _r: done.release())
    scene.set_camera(base)
    assert all(done.acquire(timeout=WAIT) for _ in bufs)
    assert [bytes(b) for b in bufs] == eager
