"""The program's spans and counters in a run (``gbench/program.py``): the
per-frame arithmetic on hand-made records, a CPU run with the program's
tracing on whose spans sit inside the harness's, a run that leaves the
program's tracing off, and (marked ``gpu``) the walk kernels of each
cell's traced frames inside their spans on the mapped clock."""

import time

import pytest

from gbench import cell, program, spec

from test_gpubench_faults import RUNS

MS = 1_000_000          # a millisecond in nanoseconds
S = 1_000_000_000


def span(sid, name, start_ms, end_ms, frame=None, parent=None, base=100):
    """A span dict at ``base`` seconds plus the given milliseconds."""
    return dict(name=name, start=base * S + int(start_ms * MS),
                end=base * S + int(end_ms * MS), id=sid, parent=parent,
                thread=1, frame=frame, attrs={})


def frame_spans(frame, at_ms, ids):
    """One frame at ``at_ms``: a 10 ms dispatch holding a 2 ms walk and a
    3 ms shade that holds a 1 ms occlusion; a 6 ms pull, 4 ms of wait and
    1 ms of write."""
    i = next(ids)
    d, sh, p = i, i + 1, i + 2
    for _ in range(6):
        next(ids)
    return [
        span(d, "frame.dispatch", at_ms, at_ms + 10, frame),
        span(i + 3, "dispatch.walk", at_ms + 1, at_ms + 3, frame, d),
        span(sh, "dispatch.shade", at_ms + 3, at_ms + 6, frame, d),
        span(i + 4, "dispatch.occlusion", at_ms + 4, at_ms + 5, frame, sh),
        span(p, "frame.pull", at_ms + 10, at_ms + 16, frame),
        span(i + 5, "pull.wait", at_ms + 10, at_ms + 14, frame, p),
        span(i + 6, "pull.write", at_ms + 14, at_ms + 15, frame, p),
    ]


def synthetic_run(traced=None):
    """Frames 1 and 4 lie outside the window [100 s, 110 s); frames 2 and 3
    inside, frame 3 with a second walk inside the first (counted once)."""
    import itertools
    ids = itertools.count(1)
    sp = [span(900, "scene.load_obj", -3000, -2000),
          span(901, "scene.kd_build", -2000, -500),
          span(902, "scene.device", -500, -100),
          span(903, "scene.device", 20000, 20100)]
    for frame, at in ((1, -50), (2, 500), (3, 5000), (4, 10500)):
        sp += frame_spans(frame, at, ids)
    walk3 = [s for s in sp if s["frame"] == 3 and s["name"] ==
             "dispatch.walk"][0]
    sp.append(span(999, "dispatch.walk", 5001.5, 5002, 3, walk3["id"]))
    counters = {f: {"chunks_visited": 100 * f, "rays_traced": 7}
                for f in (1, 2, 3, 4)}
    return dict(t_w0=100.0, t_w1=110.0, traced=traced,
                program=dict(spans=sp, counters=counters))


def test_per_frame_readers_keep_the_window():
    run = synthetic_run()
    assert program.window_frames(run) == [2, 3]
    assert program.setup_s(run, "scene.load_obj") == pytest.approx(1.0)
    assert program.setup_s(run, "scene.kd_build") == pytest.approx(1.5)
    # the device scene rebuilt after the window opened is no set-up
    assert program.setup_s(run, "scene.device") == pytest.approx(0.4)
    assert program.setup_s(run, "scene.nothing") is None
    out = program.read(run, "video")
    # self time: the dispatch's 10 ms without its walk (2) and the
    # occlusion inside its shade (1); the nested walk counts once
    assert out["glue_ms.video"] == pytest.approx(7.0)
    assert out["walk_launch_ms.video"] == pytest.approx(3.0)
    assert out["pull_wait_ms.video"] == pytest.approx(4.0)
    assert out["pull_write_ms.video"] == pytest.approx(1.0)
    assert out["walk_visits.video"] == pytest.approx(250.0)
    assert out["kd_build_s"] == pytest.approx(1.5)
    assert out["idle_glue_pct.video"] is None


def test_per_frame_readers_find_nothing_without_records():
    run = dict(t_w0=100.0, t_w1=110.0, traced=None)
    out = program.read(run, "mesh")
    assert set(out) == {"load_obj_s", "kd_build_s", "device_scene_s",
                        "glue_ms.mesh", "walk_launch_ms.mesh",
                        "pull_wait_ms.mesh", "pull_write_ms.mesh",
                        "walk_visits.mesh", "idle_glue_pct.mesh"}
    assert all(v is None for v in out.values())


def _traced(ops):
    """The profiled window opens at host time 110.5 s (frame 4 at 10.5 s
    of the window's clock is 0 on the trace), 0.02 s long."""
    return dict(ops=ops, window_s=0.02, offset=110.5, frames=1, first=4)


def test_idle_during_glue_and_by_span():
    # frame 4 on the trace: dispatch [0, 10) ms, walk [1, 3), shade
    # [3, 6) with occlusion [4, 5), pull [10, 16) with wait [10, 14) and
    # write [14, 15); the device is busy [2, 5) and [12, 13)
    ops = [("nearest_stream_kernel<4, true>", 0.002, 0.005),
           ("Memcpy DtoH", 0.012, 0.013)]
    run = synthetic_run(_traced(ops))
    assert program.traced_frames(run) == [4]
    # idle in the glue: [0, 1) and [5, 10) minus the walk, the occlusion's
    # [4, 5) is no glue, and it is busy: 6 ms of 20
    assert program.idle_glue_pct(run) == pytest.approx(30.0)
    got = dict(program.idle_by_span(run))
    assert got == {
        "frame.dispatch": pytest.approx(0.001 + 0.004),
        "dispatch.walk": pytest.approx(0.001),
        "dispatch.shade": pytest.approx(0.001),
        "pull.wait": pytest.approx(0.002 + 0.001),
        "pull.write": pytest.approx(0.001),
        "frame.pull": pytest.approx(0.001),
        "none": pytest.approx(0.004)}
    assert program.note(run).startswith("idle s of the traced frames")
    n, faults = program.alignment(run)
    assert n == 1 and faults == []


@pytest.mark.parametrize("at", [0.0005, 0.0161])
def test_alignment_finds_a_kernel_outside_its_spans(at):
    ops = [("nearest_stream_kernel<4, true>", at, at + 0.001)]
    n, faults = program.alignment(synthetic_run(_traced(ops)))
    assert n == 1 and len(faults) == 1


def test_a_run_without_the_program_tracing_leaves_it_off(bench):
    from ntracer_tpu_torch import tracing
    tracing.drain()
    name, over = RUNS["video"]
    result, _lines, _notes = cell.run_cell(
        name, 2**31 + 11, 1.0, False, time.perf_counter(), device="cpu",
        bench=bench, overrides=over)
    assert result["correct"]
    assert not tracing.enabled()
    assert tracing.drain() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("run_name", sorted(RUNS))
def test_the_program_spans_sit_inside_the_harness_calls(bench, run_name):
    name, over = RUNS[run_name]
    result, _lines, _notes, run = program.run_cell(
        name, 2**31 + 5, 4.0, True, device="cpu", bench=bench,
        overrides=over)
    assert result["correct"]
    suffix = "mesh" if name.startswith("mesh") else "video"
    got = program.read(run, suffix)
    expect_none = {f"idle_glue_pct.{suffix}"}       # no device trace here
    if suffix == "video":
        expect_none.add("load_obj_s")
    assert {k for k, v in got.items() if v is None} == expect_none
    metrics = result["metrics"]
    dispatch = metrics[f"dispatch_ms.{suffix}"]["value"]
    pull = metrics[f"pull_ms.{suffix}"]["value"]
    assert got[f"glue_ms.{suffix}"] + got[f"walk_launch_ms.{suffix}"] \
        <= dispatch
    assert got[f"pull_wait_ms.{suffix}"] + got[f"pull_write_ms.{suffix}"] \
        <= pull
    # each program dispatch and pull inside a call the harness timed
    ns = [(a * 1e9, b * 1e9) for a, b in run["spans"]["dispatch"]]
    pulls = [(a * 1e9, b * 1e9) for a, b in run["spans"]["pull"]]
    for s in program.spans(run):
        if s["frame"] not in program.window_frames(run):
            continue
        outer = {"frame.dispatch": ns, "frame.pull": pulls}.get(s["name"])
        if outer is not None:
            assert any(a <= s["start"] and s["end"] <= b for a, b in outer)
    if run["traffic"]["renderer"] == "callback":
        assert program.ms_per_frame(run, ("frame.queue",)) is not None


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_walk_kernels_start_inside_their_spans(name, card):
    result, _lines, notes, run = program.run_cell(
        name, 2718281849, 4.0, True, device="cuda:0")
    n, faults = program.alignment(run)
    suffix = "mesh" if name.startswith("mesh") else "video"
    print(name, program.read(run, suffix), program.note(run))
    assert result["correct"] and n >= run["traced"]["frames"]
    assert faults == []
