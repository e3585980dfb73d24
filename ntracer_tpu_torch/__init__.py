"""ntracer_tpu_torch: the hyper-spatial ray tracer on PyTorch and CUDA.

A port of ``ntracer_tpu`` (JAX on a TPU) to PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.  The package stands alone: it has its own scene
API (``NTracer``, ``Color``, ``Material``, ``Channel``, ``ImageFormat``,
``CUBE``, ``SPHERE``, the ``tracer3``..``tracer8``/``tracern`` modules) and
imports nothing of ``ntracer_tpu`` or jax.  Its renderers render on an
explicit device:

    from ntracer_tpu_torch import NTracer, BlockingRenderer, ...
    BlockingRenderer(device="cuda").render(buf, fmt, scene)
    CallbackRenderer(device="cuda").begin_render(buf, fmt, scene, callback)

``python -m ntracer_tpu_torch.alias SCRIPT`` runs a script written for the
reference's ``ntracer`` package on the port.
"""

from .render import (Color, Material, Channel, ImageFormat, LockedError,
                     CallbackRenderer, BlockingRenderer)
from .wrapper import NTracer, CUBE, SPHERE
from . import render
from . import wrapper

__all__ = ["Color", "Material", "Channel", "ImageFormat", "LockedError",
           "CallbackRenderer", "BlockingRenderer", "NTracer", "CUBE",
           "SPHERE", "render", "wrapper"]


def __getattr__(name):
    # the version asks git on first use, not at import
    if name == "__version__":
        from ._version import get_version
        globals()["__version__"] = version = get_version()
        return version
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
