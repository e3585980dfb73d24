"""Find a cell, its configuration, its traffic mix and its metrics by name.

Everything the harness runs is named in ``BENCHMARK.json`` at the root of
the checkout and found in files of its own under ``gpubench/``:

- a configuration: the JSON file its entry names (``configs/<name>.json``),
  whose ``builder`` names a scene builder ``scenes/<builder>.py``;
- a traffic mix: ``traffic/<mix>.json``, read by the one generator in
  ``gbench/loops.py``;
- a metric: ``metrics/<name>.py``, whose ``read(run)`` returns its value or
  None;
- a cell's comparison: ``checks/<cell>.json`` (the frames and pixels
  compared, the tolerance, the limit).

A new cell, configuration, mix or metric is new files and new entries; no
file here changes.
"""

from __future__ import annotations

import copy
import hashlib
import importlib.util
import json
import os

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
# what a run makes once a checkout and reads again (the mesh's OBJ file)
CACHE_DIR = os.path.join(BENCH_DIR, "cache")


def load_benchmark(path=None):
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def read_json(path):
    with open(path) as f:
        return json.load(f)


def merge(base, extra):
    """A copy of ``base`` with the keys of ``extra`` replaced."""
    out = copy.deepcopy(base)
    out.update(extra or {})
    return out


def check_file(cell_name, root=BENCH_DIR):
    """The cell's comparison settings and limit, ``checks/<cell>.json``."""
    return read_json(os.path.join(root, "checks", cell_name + ".json"))


def simplices(builder, config):
    """The configuration's geometry, (N, d, d) float32: made by its builder
    once a checkout and kept in ``CACHE_DIR`` under a hash of the
    configuration (written to a temporary name first, so a run never reads
    half a file)."""
    key = hashlib.sha1(json.dumps(config, sort_keys=True).encode())
    path = os.path.join(CACHE_DIR, f"{config['builder']}_"
                        f"{key.hexdigest()[:16]}.npy")
    if os.path.isfile(path):
        return np.load(path)
    tris = builder.simplices(config, CACHE_DIR)
    os.makedirs(CACHE_DIR, exist_ok=True)
    part = f"{path}.{os.getpid()}.part"
    with open(part, "wb") as f:
        np.save(f, tris)
    os.replace(part, path)
    return tris


def load_module(kind, name, root=BENCH_DIR):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(root, kind, name + ".py")
    if not os.path.isfile(path):
        raise SystemExit(f"no {kind[:-1]} file {os.path.relpath(path, REPO)}")
    mod_name = "gpubench_" + kind + "_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench, cell_name, root=BENCH_DIR):
    """The cell's entry, its configuration (entry and file contents), its
    traffic mix and the metrics it reports, with and without a trace."""
    cell = _by_name(bench["workloads"], cell_name, "workload")
    conf = _by_name(bench["configs"], cell["config"], "config")
    config = read_json(os.path.join(os.path.dirname(root), conf["file"]))
    traffic = read_json(os.path.join(root, "traffic", cell["traffic"] + ".json"))

    def applies(m):
        return cell_name in m.get("workloads", [cell_name])

    end_to_end = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m) and ("workloads" in m or m["moves"] in reported)]
    return dict(cell=cell, config_entry=conf, config=config, traffic=traffic,
                end_to_end=end_to_end, per_layer=per_layer)
