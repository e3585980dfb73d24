"""The rate, tail, span and idle arithmetic of the metric readers on
hand-made frame times and device traces."""

import numpy as np
import pytest

from gbench import readers, spec, trace


def run_of(records, **kw):
    run = dict(records=records, t_w0=100.0, t_w1=110.0, seconds=10.0,
               fmt=dict(width=1024, height=1024), traffic=dict(
                   renderer="blocking"), spans={}, traced=None)
    run.update(kw)
    return run


def frames(n, t0=100.0, dt=0.1, lat=0.05):
    return [(k, t0 + k * dt, t0 + k * dt + lat) for k in range(n)]


def test_rate_counts_frames_done_in_the_window():
    # frame 99 is done at 109.95, frame 100 at 110.15: a quarter of its
    # completion interval lies in the window
    recs = frames(100) + [(100, 109.99, 110.15), (101, 110.2, None)]
    run = run_of(recs)
    assert len(readers.done_in_window(run)) == 100
    assert readers.frames_in_window(run) == pytest.approx(100.25)
    assert readers.mrays_s(run) == pytest.approx(
        100.25 * 1024 * 1024 / 10 / 1e6)
    assert readers.frames_in_window(run_of(frames(10))) == 10
    for name in ("mrays_s", "video_mrays_s"):
        assert spec.load_module("metrics", name).read(run) == \
            readers.mrays_s(run)


def test_tail_over_every_frame():
    lat = np.linspace(0.010, 0.029, 20)
    recs = [(k, 100 + k, 100 + k + lat[k]) for k in range(10)] + \
        [(k, 100.5 + k * 0.1, 100.5 + k * 0.1 + lat[k]) for k in range(10, 20)]
    run = run_of(recs)
    assert readers.p95_ms(run) == pytest.approx(
        np.percentile(1e3 * lat, 95))
    for name in ("frame_ms_p95", "video_frame_ms_p95"):
        assert spec.load_module("metrics", name).read(run) == \
            pytest.approx(np.percentile(1e3 * lat, 95))


def test_span_ms_per_frame_keeps_the_window():
    spans = {"dispatch": [(99.0, 99.5), (100.0, 100.01), (101.0, 101.03),
                          (110.5, 111.0)]}
    run = run_of([], spans=spans)
    assert readers.span_ms_per_frame(run, "dispatch") == pytest.approx(20.0)
    assert readers.span_ms_per_frame(run, "pull") is None


def test_idle_and_kernel_time_from_a_trace():
    ops = [("nearest_stream_kernel<4, true>", 0.0, 0.2),
           ("add", 0.1, 0.3), ("copy", 0.5, 0.6), ("gap-free", 0.6, 0.7)]
    run = run_of([], traced=dict(ops=ops, window_s=1.0, frames=2))
    assert readers.device_idle_pct(run) == pytest.approx(50.0)
    assert readers.kernel_ms_per_frame(run, "nearest_stream_kernel") == \
        pytest.approx(100.0)
    assert readers.kernel_ms_per_frame(run, "grid_nearest") is None
    assert trace.gaps(ops, 1.0) == [(0.3, 0.5), (0.7, 1.0)]
    idle = trace.idle_by_host(ops, 1.0, {"pull": [(10.31, 10.49)],
                                         "camera": [(10.75, 10.8)]}, 10.0)
    assert idle == [("camera (1 gaps)", pytest.approx(0.3)),
                    ("pull (1 gaps)", pytest.approx(0.2))]
    assert trace.by_name(ops)[0] == ("nearest_stream_kernel<4, true>",
                                     pytest.approx(0.2))


def test_short_kernel_names():
    name = ("void (anonymous namespace)::nearest_stream_kernel<4, true>"
            "(float const*, int)")
    assert trace.short_name(name) == "nearest_stream_kernel<4, true>"
