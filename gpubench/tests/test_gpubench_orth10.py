"""The orthoplex cell (``orth10.video1080``) shrunk for the CPU: a sound
run is correct, with the trace and without; the timed path broken
underneath by each planted fault is not, nor is the control (the reference
a precision below the configuration's).  Marked ``gpu``: at the cell's
size, with the program's tracing on, every grid walk kernel of the traced
frames starts inside its ``dispatch.walk`` span, which says ``walk="grid"``,
and every window frame counts the tiles its walk ran."""

import json
import time

import pytest

import planted
from gbench import cell, control, program, spec

CELL = "orth10.video1080"
# a CPU frame of the grid walk's twin at d = 10 takes a second or two
SMALL = {"traffic": {"width": 63, "height": 47, "warmup_frames": 1,
                     "trace_frames": 2},
         "check": {"within_frames": 3, "frames": 2, "pixels": 1024}}


def small_run(bench, fault=None, seed=2**31 + 3, trace=False):
    return cell.run_cell(CELL, seed, 5.0, trace, time.perf_counter(),
                         device="cpu", bench=bench, overrides=SMALL,
                         fault=fault)


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(bench, trace):
    result, lines, _notes = small_run(bench, trace=trace)
    assert result["correct"], lines
    assert result["attempted"] >= 2 and result["failed"] == 0
    # on the CPU the trace holds no device operation to read
    sp = spec.resolve(bench, CELL)
    assert set(result["metrics"]) == {
        m["name"] for m in sp["per_layer" if trace else "end_to_end"]
        if m["source"] != "device_trace"}
    json.dumps(result)


@pytest.mark.parametrize("make", planted.FAULTS)
def test_a_broken_path_is_not_correct(bench, make, monkeypatch):
    result, lines, _notes = small_run(bench, fault=make(monkeypatch))
    assert not result["correct"]
    worst, limit = lines["worst_frame_off_share"]
    assert worst > limit


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 99])
def test_the_control_is_not_correct(bench, seed):
    shares, _gaps, limit = control.control_shares(CELL, seed, "cpu", SMALL,
                                                  bench=bench)
    assert max(shares) > limit, (seed, shares)


@pytest.mark.gpu
def test_grid_walk_kernels_start_inside_their_spans(card):
    result, _lines, notes, run = program.run_cell(
        CELL, 2718281849, 4.0, True, device="cuda:0")
    n, faults = program.alignment(run, kernel="grid_nearest_kernel")
    frames = set(program.traced_frames(run))
    walks = [s for s in program.spans(run, "dispatch.walk")
             if s["frame"] in frames]
    counters = run["program"]["counters"]
    tiles = [counters[f].get("grid_tiles_visited", 0)
             for f in program.window_frames(run)]
    print(CELL, f"{n} grid walk kernels traced; grid_tiles_visited of the "
          f"window frames {sorted(set(tiles))}; {program.note(run)}")
    assert result["correct"] and n >= run["traced"]["frames"]
    assert faults == []
    assert walks and all(s["attrs"].get("walk") == "grid" for s in walks)
    assert tiles and min(tiles) > 0
