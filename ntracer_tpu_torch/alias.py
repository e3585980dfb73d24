"""Run a script written for the reference's ``ntracer`` package on the port.

    python -m ntracer_tpu_torch.alias [--device cuda|cpu] SCRIPT [ARGS...]

The port's counterpart of the repository's ``ntracer/`` alias package: the
names ``ntracer``, ``ntracer.render``, ``ntracer.wrapper``,
``ntracer.tracer3`` .. ``ntracer.tracer8``, ``ntracer.tracern``,
``ntracer.wavefront_obj`` and ``ntracer.pygame_render`` are registered in
``sys.modules`` as the port's modules, and ``ntracer_tpu`` as a module that
holds only ``primitives``, the port's (``scripts/polytope.py`` imports
``ntracer_tpu.primitives``).  The JAX package is never imported.  The
renderers under those names (``BlockingRenderer``, ``CallbackRenderer``,
``PygameRenderer``) render on ``--device`` unless the script names another.
Then SCRIPT runs as ``__main__`` with ARGS as its arguments.
"""

from __future__ import annotations

import argparse
import importlib
import runpy
import sys
import types

PORT = "ntracer_tpu_torch"
# the reference's submodules; the port's modules of the same names stand for
# them
NAMES = ("render", "wrapper", "tracern", "wavefront_obj", "pygame_render",
         *(f"tracer{d}" for d in range(3, 9)))
RENDERERS = ("BlockingRenderer", "CallbackRenderer", "PygameRenderer")


def _on_device(cls, device, module):
    """``cls`` with ``device`` as the default of its ``device`` argument."""

    def __init__(self, *args, device=device, **kwargs):
        cls.__init__(self, *args, device=device, **kwargs)

    return type(cls.__name__, (cls,), {"__init__": __init__,
                                       "__module__": module,
                                       "__qualname__": cls.__qualname__})


def _module(name, source, device):
    """A module named ``name`` holding ``source``'s names, its renderers
    defaulting to ``device``."""
    mod = types.ModuleType(name, source.__doc__)
    mod.__dict__.update({k: v for k, v in vars(source).items()
                         if not k.startswith("__")})
    for cls in RENDERERS:
        if cls in vars(source):
            setattr(mod, cls, _on_device(getattr(source, cls), device, name))
    return mod


def install(device="cuda"):
    """Register ``ntracer``, its submodules and ``ntracer_tpu.primitives``
    as the port's modules (see the module's docstring); returns the
    ``ntracer`` module."""
    top = types.ModuleType("ntracer", __doc__)
    top.__path__ = []
    sys.modules["ntracer"] = top
    for name in NAMES:
        mod = importlib.import_module(f"{PORT}.{name}")
        if any(cls in vars(mod) for cls in RENDERERS):
            mod = _module(f"ntracer.{name}", mod, device)
        sys.modules[f"ntracer.{name}"] = mod
        setattr(top, name, mod)
    # the package's own names; its renderers are those of ntracer.render
    port = importlib.import_module(PORT)
    for name in port.__all__:
        if name not in NAMES:
            setattr(top, name, getattr(top.render, name, None)
                    or getattr(port, name))
    tpu = types.ModuleType("ntracer_tpu",
                           "The port's primitives under the JAX package's "
                           "name.")
    tpu.__path__ = []
    tpu.primitives = importlib.import_module(f"{PORT}.primitives")
    sys.modules["ntracer_tpu"] = tpu
    sys.modules["ntracer_tpu.primitives"] = tpu.primitives
    return top


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m ntracer_tpu_torch.alias",
        description="Run a script written for the ntracer package on "
                    "ntracer_tpu_torch.")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="the renderers' default device (default: cuda)")
    parser.add_argument("script", help="the script to run")
    parser.add_argument("args", nargs=argparse.REMAINDER,
                        help="the script's arguments")
    args = parser.parse_args(argv)
    install(args.device)
    sys.argv = [args.script, *args.args]
    runpy.run_path(args.script, run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
