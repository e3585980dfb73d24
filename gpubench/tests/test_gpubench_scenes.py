"""The frozen scene builders give what the originals give: the simplices of
scripts/polytope.py 5 3 3 and the 495,612 triangles of the sphere mesh,
which reach the program exactly through the OBJ file."""

import ast
import math
import os

import numpy as np

from gbench import spec

REPO = spec.REPO


def script_functions(path, names):
    """The named top-level functions of a script, without running its
    imports (scripts/polytope.py imports the JAX package's alias)."""
    tree = ast.parse(open(path).read())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"np": np, "math": math}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns


def test_polytope_matches_scripts_polytope():
    scenes = spec.load_module("scenes", "polytope")
    orig = script_functions(
        os.path.join(REPO, "scripts", "polytope.py"),
        {"mirror_normals", "_initial_vertex", "_reflect",
         "polytope_vertices"})
    want = orig["polytope_vertices"]([5, 3, 3])
    got = scenes.polytope_vertices([5, 3, 3])
    assert len(got) == 600
    np.testing.assert_array_equal(got, want)
    conf = spec.read_json(os.path.join(REPO, "gpubench", "configs",
                                       "polytope_120cell.json"))
    tris = scenes.simplices(conf, None)
    assert tris.shape == (3240, 4, 4) and tris.dtype == np.float32
    import chip_smoke
    np.testing.assert_array_equal(
        tris, chip_smoke.hull_simplices(chip_smoke.polytope_vertices([5, 3, 3])))


def test_sphere_matches_bench_mesh():
    import chip_smoke
    scenes = spec.load_module("scenes", "obj_mesh")
    tris = scenes.sphere_mesh(500000)
    assert tris.shape == (495612, 3, 3)
    np.testing.assert_array_equal(tris, chip_smoke.sphere_mesh(500000))


def test_obj_file_reads_back_exactly(tmp_path):
    from ntracer_tpu_torch import NTracer
    scenes = spec.load_module("scenes", "obj_mesh")
    conf = dict(tris=2000)
    tris = scenes.simplices(conf, None)
    protos = scenes.prototypes(conf, NTracer(3), tris, str(tmp_path))
    assert os.path.isfile(scenes.obj_path(conf, str(tmp_path)))
    assert len(protos) == len(tris)
    got = np.stack([np.stack([np.asarray(list(p.point))
                              for p in protos[i].point_data])
                    for i in (0, len(tris) // 2, len(tris) - 1)])
    np.testing.assert_array_equal(got, tris[[0, len(tris) // 2, -1]])
    again = scenes.prototypes(conf, NTracer(3), tris, str(tmp_path))
    assert len(again) == len(tris)
