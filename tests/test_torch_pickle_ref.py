"""Pickles made by the reference's C++ extension load through the port.

The fixtures in tests/fixtures/ name ``ntracer.render._*_unpickle``
(tests/test_pickle_compat.py loads them through the ``ntracer`` alias of the
JAX package).  Here an Unpickler maps ``ntracer.`` to ``ntracer_tpu_torch.``,
so each fixture becomes an object of the port, holds what
test_pickle_compat.py checks, and round-trips through the port's own
pickles."""

import io
import os
import pickle

import pytest

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


class PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "ntracer" or module.startswith("ntracer."):
            module = "ntracer_tpu_torch" + module[len("ntracer"):]
        return super().find_class(module, name)


def load(name):
    with open(os.path.join(FIXTURES, name + ".pkl"), "rb") as f:
        return PortUnpickler(io.BytesIO(f.read())).load()


def _rounded(xs):
    return [round(float(x), 6) for x in xs]


CHECKS = {
    "color": lambda c: _rounded(c) == [0.1, 0.2, 0.3],
    "material": lambda m: (abs(m.opacity - 0.8) < 1e-6
                           and abs(m.reflectivity - 0.3) < 1e-6
                           and abs(m.specular_intensity - 0.9) < 1e-6
                           and abs(m.specular_exp - 6) < 1e-6
                           and _rounded(m.specular) == [0.2, 0.4, 0.6]),
    "vector3": lambda v: list(v) == [1, 2, 3],
    "vector5": lambda v: list(v) == [1, 2, 3, 4, 5] and v.dimension == 5,
    "matrix3": lambda m: list(m.values) == [1, 2, 3, 4, 5, 6, 7, 8, 10],
    "aabb3": lambda a: list(a.start) == [-1, -2, -3]
    and list(a.end) == [4, 5, 6],
    "triangle5": lambda t: t.dimension == 5 and len(list(t.edge_normals)) == 4,
    # the reference was built with BATCH_SIZE == 8, as the port is
    "batch3": lambda b: len(b) == 8,
    "solid3": lambda s: s.type == 1 and list(s.position) == [1, 2, 3],
}


def test_fixture_list_is_complete():
    names = sorted(n[:-4] for n in os.listdir(FIXTURES) if n.endswith(".pkl"))
    assert names == sorted(CHECKS)


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_reference_pickle_loads_into_the_port(name):
    obj = load(name)
    assert type(obj).__module__.startswith("ntracer_tpu_torch.")
    assert CHECKS[name](obj)
    data = pickle.dumps(obj)
    assert b"ntracer_tpu_torch" in data
    back = pickle.loads(data)
    assert type(back) is type(obj)
    assert CHECKS[name](back)
    assert pickle.dumps(back) == data
