"""``correct`` can fail: a whole run on the CPU at a small size (the
harness's look for a card skipped) with the timed path broken underneath,
once for each fault a renderer cell can have, and the control (the
reference a precision below the configuration's) in the program's place."""

import json
import os
import time

import pytest

import planted
from gbench import cell, control, spec

# odd sizes: no pixel column or row on the screen's centre lines, whose
# rays lie in a mirror hyperplane of the 120-cell on every step of the
# orbit (PERF.md: the program drops some of them between mirror images)
SMALL = {"traffic": {"width": 63, "height": 47, "warmup_frames": 1},
         "check": {"within_frames": 3, "frames": 2, "pixels": 1024}}
MESH = dict(SMALL, config={"tris": 3000})
# the viewer's mix (traffic/view1024.json): CallbackRenderer, three buffers
VIEW = spec.read_json(os.path.join(spec.BENCH_DIR, "traffic",
                                   "view1024.json"))
CALLBACK = dict(SMALL, traffic=dict(VIEW, **SMALL["traffic"]))
# (cell, overrides): the video cell's blocking loop, the same cell through
# the viewer's CallbackRenderer loop, the mesh cell
RUNS = {"video": ("cell120.video1080", SMALL),
        "callback": ("cell120.video1080", CALLBACK),
        "mesh": ("mesh500k.orbit1024", MESH)}


def small_run(bench, run, fault=None, seed=2**31 + 3, trace=False):
    name, over = RUNS[run]
    result, lines, _notes = cell.run_cell(
        name, seed, 1.5, trace, time.perf_counter(), device="cpu",
        bench=bench, overrides=over, fault=fault)
    return result, lines


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_a_sound_run_is_correct(bench, run, trace):
    result, lines = small_run(bench, run, trace=trace)
    assert result["correct"], lines
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert list(result)[-1] == "check"
    # on the CPU the trace holds no device operation to read
    sp = spec.resolve(bench, RUNS[run][0])
    assert set(result["metrics"]) == {
        m["name"] for m in sp["per_layer" if trace else "end_to_end"]
        if m["source"] != "device_trace"}
    json.dumps(result)


@pytest.mark.parametrize("make", planted.FAULTS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_a_broken_path_is_not_correct(bench, run, make, monkeypatch):
    result, lines = small_run(bench, run, fault=make(monkeypatch))
    assert not result["correct"]
    assert lines["worst_frame_off_share"][0] > lines[
        "worst_frame_off_share"][1]


def test_the_control_is_not_correct(bench):
    for run in ("video", "mesh"):
        name, over = RUNS[run]
        for seed in (1, 2**31 + 7, 99):
            shares, _gaps, limit = control.control_shares(
                name, seed, "cpu", over, bench=bench)
            assert max(shares) > limit, (name, seed, shares)
