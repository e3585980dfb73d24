"""The harness finds a cell, its configuration, its mix and its metrics by
name from files alone, and a cell added as files only is found."""

import json
import os
import shutil

from gbench import check, spec


def test_every_cell_resolves_from_files(bench):
    for w in bench["workloads"]:
        sp = spec.resolve(bench, w["name"])
        assert sp["config"]["builder"]
        assert sp["traffic"]["renderer"] in ("blocking", "callback")
        assert spec.load_module("scenes", sp["config"]["builder"])
        names = {m["name"] for m in sp["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert sp["per_layer"]
        for m in sp["end_to_end"] + sp["per_layer"]:
            assert callable(spec.load_module("metrics", m["name"]).read)
        chk = spec.check_file(w["name"])
        assert 0 < chk["limit"] < 1


def test_config_files_are_under_paths():
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert os.path.isfile(os.path.join(spec.REPO, c["file"]))


def test_a_cell_added_as_files_only_is_found(tmp_path):
    """Copy the benchmark's files, add a configuration, a mix, a metric, a
    check and a cell as new files and entries: all are found by name."""
    root = tmp_path / "gpubench"
    shutil.copytree(spec.BENCH_DIR, root,
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    bench = spec.load_benchmark()
    conf = json.loads((root / "configs" / "polytope_120cell.json").read_text())
    conf["schlafli"] = [3, 3, 3]
    (root / "configs" / "polytope_simplex.json").write_text(json.dumps(conf))
    mix = json.loads((root / "traffic" / "view1024.json").read_text())
    mix.update(width=800, height=600)
    (root / "traffic" / "view800x600.json").write_text(json.dumps(mix))
    (root / "metrics" / "frames_done.py").write_text(
        "def read(run):\n    return len(run['records'])\n")
    (root / "checks" / "simplex.view800x600.json").write_text(json.dumps(
        dict(frames=2, within_frames=10, pixels=64, tolerance=1, limit=0.01)))
    bench["configs"].append(dict(name="polytope_simplex", source="x",
                                 file="gpubench/configs/polytope_simplex.json",
                                 reduced=[], why="x"))
    bench["workloads"].append(dict(name="simplex.view800x600",
                                   config="polytope_simplex",
                                   traffic="view800x600", chips=1, why="x"))
    bench["per_layer"].append(dict(name="frames_done", unit="frames",
                                   better="higher", source="program_counter",
                                   layer="renderer front end",
                                   moves="mrays_s",
                                   workloads=["simplex.view800x600"]))
    bench["end_to_end"][0]["workloads"].append("simplex.view800x600")
    sp = spec.resolve(bench, "simplex.view800x600", root=str(root))
    assert sp["config"]["schlafli"] == [3, 3, 3]
    assert (sp["traffic"]["width"], sp["traffic"]["height"]) == (800, 600)
    assert "frames_done" in {m["name"] for m in sp["per_layer"]}
    mod = spec.load_module("metrics", "frames_done", root=str(root))
    assert mod.read(dict(records=[1, 2, 3])) == 3
    scenes = spec.load_module("scenes", sp["config"]["builder"],
                              root=str(root))
    assert scenes.simplices(sp["config"], None).shape == (5, 4, 4)


def test_kept_frames_follow_the_seed():
    chk = dict(frames=4, within_frames=300)
    assert check.kept_frames(2**31 + 11, chk) == check.kept_frames(2**31 + 11,
                                                                 chk)
    assert check.kept_frames(1, chk) != check.kept_frames(2, chk)
    assert all(0 <= k < 300 for k in check.kept_frames(5, chk))
