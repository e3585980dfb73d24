"""ntracer_tpu_torch: the hyper-spatial ray tracer on PyTorch and CUDA.

A port of ``ntracer_tpu`` (JAX on a TPU) to PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.  The package stands alone: it has its own scene
API (``NTracer``, ``Color``, ``Material``, ``Channel``, ``ImageFormat``,
``CUBE``, ``SPHERE``, the ``tracer3``..``tracer8``/``tracern`` modules) and
imports nothing of ``ntracer_tpu`` or jax.  Its ``BlockingRenderer`` renders
on an explicit device:

    from ntracer_tpu_torch import NTracer, BlockingRenderer, ...
    BlockingRenderer(device="cuda").render(buf, fmt, scene)
"""

from .render import (Color, Material, Channel, ImageFormat, LockedError,
                     BlockingRenderer)
from .wrapper import NTracer, CUBE, SPHERE
from . import render
from . import wrapper

__all__ = ["Color", "Material", "Channel", "ImageFormat", "LockedError",
           "NTracer", "CUBE", "SPHERE", "BlockingRenderer", "render",
           "wrapper"]
