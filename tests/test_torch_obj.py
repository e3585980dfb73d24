"""The port's Wavefront OBJ loader vs the JAX package's, on the cases of
tests/test_apps.py: the prototypes' fields are equal bit for bit, and the
same files are refused the same way."""

import numpy as np
import pytest

from ntracer_tpu import wavefront_obj as jobj
from ntracer_tpu_torch import wavefront_obj as pobj
from ntracer_tpu_torch import NTracer, BlockingRenderer
from ntracer_tpu_torch.primitives import TrianglePrototype

from _torch_helpers import JAX, api, rgb8

TET = """# a tetrahedron
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
f 1 2 3
f 1 2 4
f 1 3 4
f 2 3 4
"""

GOOD = {
    "tetrahedron": TET,
    # a quad and a pentagon: fans from their first vertex
    "fans": ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv -0.5 0.5 0.3\n"
             "f 1 2 3 4\nf 1 2 3 4 5\n"),
    "negative_indices": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n",
    # texture and normal references keep only the vertex index; other
    # records are ignored
    "vertex_refs": ("v 0.25 0 0 1.0\nv 1 0.5 0\nv 0 1 0.75\nvt 0 0\n"
                    "vn 0 0 1\nvt 1 0\nvt 0 1\no thing\ng part\n"
                    "f 1/1 2/2 3/3\nf 1/1/1 3//1 2/3/1\n"),
    # a negative index counts back from the vertices read so far
    "interleaved": ("v 0 0 0\nv 2 0 0\nv 0 2 0\nf -1 -2 -3\n"
                    "v 0 0 2\nf 1 -1 -2\n"),
}

BAD = {
    "vertex_text": "v zero zero zero\n",
    "vertex_short": "v 1 2\n",
    "face_text": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 x\n",
    "face_out_of_range": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 4\n",
    "face_zero": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 0 1 2\n",
    "face_before_vertices": "f -1 -2 -3\nv 0 0 0\nv 1 0 0\nv 0 1 0\n",
}


def _load_both(tmp_path, name, text):
    path = tmp_path / f"{name}.obj"
    path.write_text(text)
    return (jobj.load_obj(str(path), api(JAX).NTracer(3)),
            pobj.load_obj(str(path), NTracer(3)))


@pytest.mark.parametrize("name", sorted(GOOD))
def test_prototypes_match_the_jax_loader(tmp_path, name):
    ref, got = _load_both(tmp_path, name, GOOD[name])
    assert len(got) == len(ref) > 0
    a, b = ref._src_arrays, got._src_arrays
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)), k
    for r, g in zip(ref, got):
        assert isinstance(g, TrianglePrototype)
        assert type(g.material).__module__ == "ntracer_tpu_torch.render"
        assert tuple(g.material.color) == tuple(r.material.color)
        assert np.array_equal(np.asarray(g.face_normal),
                              np.asarray(r.face_normal))
        assert np.array_equal(np.asarray(g.boundary.start),
                              np.asarray(r.boundary.start))
        assert np.array_equal(np.asarray(g.boundary.end),
                              np.asarray(r.boundary.end))
        for pr, pg in zip(r.point_data, g.point_data):
            assert np.array_equal(np.asarray(pg.point), np.asarray(pr.point))
            assert np.array_equal(np.asarray(pg.edge_normal),
                                  np.asarray(pr.edge_normal))


def test_fan_triangulation(tmp_path):
    _ref, got = _load_both(tmp_path, "fans", GOOD["fans"])
    assert len(got) == 2 + 3
    pts = got._src_arrays["pts"]
    # every triangle of a fan starts at the face's first vertex
    assert (pts[:, 0] == np.float32([0, 0, 0])).all()
    assert np.array_equal(pts[1], np.float32([[0, 0, 0], [1, 1, 0],
                                              [0, 1, 0]]))


def test_an_empty_mesh_loads_as_no_prototypes(tmp_path):
    path = tmp_path / "empty.obj"
    path.write_text("# nothing\nv 0 0 0\n")
    assert pobj.load_obj(str(path)) == [] == jobj.load_obj(str(path))


@pytest.mark.parametrize("name", sorted(BAD))
def test_malformed_files_raise(tmp_path, name):
    path = tmp_path / f"{name}.obj"
    path.write_text(BAD[name])
    with pytest.raises(pobj.FileFormatError, match="not a valid wavefront"):
        pobj.load_obj(str(path))
    with pytest.raises(jobj.FileFormatError):
        jobj.load_obj(str(path))


def test_only_3d_tracers(tmp_path):
    path = tmp_path / "t.obj"
    path.write_text(TET)
    with pytest.raises(ValueError, match="3-dimensional"):
        pobj.load_obj(str(path), NTracer(4))
    assert len(pobj.load_obj(str(path))) == 4       # NTracer(3) by default


def test_loaded_mesh_renders(tmp_path):
    path = tmp_path / "tet.obj"
    path.write_text(TET)
    nt = NTracer(3)
    scene = nt.build_composite_scene(pobj.load_obj(str(path), nt))
    cam = nt.Camera()
    cam.translate(nt.Vector(0.2, 0.2, -3))
    scene.set_camera(cam)
    fmt = rgb8(32, 32)
    buf = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
    assert np.frombuffer(bytes(buf), np.uint8).max() > 0
