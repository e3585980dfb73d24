"""No module under gpubench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference, the comparison and the camera paths import nothing of the
program either."""

import ast
import glob
import os

from gbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "ntracer_tpu", "ntracer"}
PROGRAM = "ntracer_tpu_torch"
# the yardstick's modules: they see only what the benchmark made
PLAIN = ("gbench/reference.py", "gbench/check.py", "gbench/orbit.py",
         "gbench/control.py", "gbench/readers.py", "gbench/trace.py",
         "gbench/spec.py")


def imported(path, whole=False):
    """Top-level names (or, with ``whole``, full module names) that the file
    imports anywhere, inside functions too."""
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out |= {f"{node.module}.{a.name}" for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out |= {f"gbench.{node.module or a.name}" for a in node.names}
    return out if whole else {m.split(".")[0] for m in out}


def files():
    return sorted(glob.glob(os.path.join(spec.BENCH_DIR, "**", "*.py"),
                            recursive=True))


def test_nothing_imports_jax_or_the_jax_package():
    assert len(files()) > 20
    for path in files():
        assert not imported(path) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_program():
    for rel in PLAIN:
        got = imported(os.path.join(spec.BENCH_DIR, rel), whole=True)
        assert not {m for m in got if m.split(".")[0] == PROGRAM}, rel
        # nor the modules that drive the program
        assert not {m for m in got if m.startswith(("gbench.cell",
                                                    "gbench.loops"))}, rel


def test_names_are_compared_whole():
    assert "ntracer_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "ntracer_tpu.engine".split(".")[0] in FORBIDDEN
