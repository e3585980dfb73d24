"""On a card, at each cell's own size: the control (the reference a
precision below the configuration's, in the program's place) and the
timed path broken underneath by each planted fault come out not correct on
three seeds.  Run with python -m pytest -m gpu -s gpubench/tests (``-s``
shows the readings)."""

import time

import pytest

import planted
from gbench import cell, control, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEEDS = (3141592653, 2718281828, 1414213562)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(name, card):
    for seed in SEEDS:
        shares, _gaps, limit = control.control_shares(name, seed, card)
        print(f"control {name} seed {seed}: worst {max(shares)} limit "
              f"{limit}")
        assert max(shares) > limit, (name, seed, shares)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("make", planted.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_fails_at_the_cells_size(name, make, seed, card,
                                              monkeypatch):
    # a window long enough to reach every kept frame
    result, lines, notes = cell.run_cell(
        name, seed, 6.0, False, time.perf_counter(), device="cuda:0",
        fault=make(monkeypatch))
    worst, limit = lines["worst_frame_off_share"]
    print(f"fault {make.__name__} {name} seed {seed}: worst {worst} limit "
          f"{limit}; {notes[1]}")
    assert not result["correct"] and worst > limit
