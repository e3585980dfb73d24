"""ntracer_tpu_torch stands alone: it imports nothing of ntracer_tpu, of the
``ntracer`` alias package, or of jax -- at run time and in its sources."""

import os
import re
import subprocess
import sys

from _torch_helpers import REPO

FORBIDDEN = ("jax", "ntracer", "ntracer_tpu")


def test_port_runs_without_the_jax_package():
    """A fresh process imports the port (its pygame renderer, its launcher
    and its mesh module too), builds a small lit scene, a lit scene of
    glass, a mesh from an OBJ file and a lit 9-D scene (the grid walks),
    renders them on the CPU (and over a 2x2 mesh of the CPU, and counts
    their frames) and unpickles one of its objects; no forbidden module was
    loaded on the way."""
    code = (
        "import pickle, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        "import ntracer_tpu_torch\n"
        "from ntracer_tpu_torch import BlockingRenderer, NTracer, Material\n"
        "import ntracer_tpu_torch.tracer4, ntracer_tpu_torch.tracern\n"
        "import ntracer_tpu_torch.pygame_render, ntracer_tpu_torch.alias\n"
        "from ntracer_tpu_torch import CallbackRenderer, __version__\n"
        "from ntracer_tpu_torch.engine import (_build, grid_kernels,\n"
        "                                      wavefront)\n"
        "from ntracer_tpu_torch.wavefront_obj import load_obj\n"
        "from ntracer_tpu_torch.parallel import mesh as pmesh\n"
        "from _torch_helpers import (glass_scene, lit_scene_3d, rgb8,\n"
        "                            orthoplex_scene)\n"
        "import os, tempfile\n"
        "obj = os.path.join(tempfile.mkdtemp(), 'tet.obj')\n"
        "open(obj, 'w').write('v 0 0 0\\nv 1 0 0\\nv 0 1 0\\nv 0 0 1\\n'\n"
        "                     'f 1 2 3\\nf 1 2 4\\nf 1 3 4 2\\n')\n"
        "nt3 = NTracer(3)\n"
        "mesh = nt3.build_composite_scene(load_obj(obj, nt3))\n"
        "cam = nt3.Camera()\n"
        "cam.translate(nt3.Vector(0.2, 0.2, -3))\n"
        "mesh.set_camera(cam)\n"
        "fmt = rgb8(32, 32)\n"
        "for scene in (lit_scene_3d(), glass_scene(100, lit=True), mesh,\n"
        "              orthoplex_scene(9)):\n"
        "    buf = bytearray(fmt.pitch * 32)\n"
        "    assert BlockingRenderer(device='cpu').render(buf, fmt, scene)\n"
        "    assert any(buf)\n"
        "    grid = pmesh.make_mesh(2, 2, devices=['cpu'] * 4)\n"
        "    assert pmesh.render_frame(scene, fmt, grid).shape == (32, 32, 3)\n"
        "    assert wavefront.frame_stats(scene, 32, 32, 'cpu')\n"
        "v = pickle.loads(pickle.dumps(NTracer(4).Vector(1, 2, 3, 4)))\n"
        "assert type(v).__module__ == 'ntracer_tpu_torch.api'\n"
        "m = pickle.loads(pickle.dumps(Material((1, 0, 0), opacity=0.5)))\n"
        "assert type(m).__module__ == 'ntracer_tpu_torch.render'\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "NTRACER_PLATFORM"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_sources_name_no_forbidden_import():
    """No ``import``/``from`` line of the port's sources or of chip_smoke.py
    names ntracer_tpu, ntracer or jax."""
    pat = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|ntracer|ntracer_tpu)(?:[.\s]|$)|"
        r"import_module\(\s*f?[\"'](?:jax|ntracer|ntracer_tpu)[.\"']")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "ntracer_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pat.search(line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: "
                               f"{line.strip()}")
    assert not bad, "\n".join(bad)
    # the pattern does catch what it is there for
    for line in ("from ntracer_tpu.render import Scene", "import jax",
                 "  from ntracer import x", "import jax.numpy as jnp",
                 'importlib.import_module("ntracer_tpu.tracern")'):
        assert pat.search(line), line
    for line in ("from ntracer_tpu_torch import NTracer", "from . import x",
                 'importlib.import_module("ntracer_tpu_torch.tracern")'):
        assert not pat.search(line), line
