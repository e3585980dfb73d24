"""``NTracer`` dimension-currying facade.

The per-dimension tracer modules (tracer3..tracer8 / tracern) expose types
whose constructors take ``dimension`` first (the reference's compiled
modules work the same way, lib/ntracer/wrapper.py:71-147).  ``NTracer(d)``
wraps the geometric types so that argument is filled in automatically and
re-exports everything else.  Instances returned by the wrappers are plain
*base-class* objects — the wrapper classes only intercept construction.
"""

import importlib
import weakref

from . import render as _render

CUBE = 1
SPHERE = 2


def _axis(base, dim, mod):
    def axis(axis, length=1):
        return base.axis(dim, axis, length)
    return axis


def _identity(base, dim, mod):
    def identity():
        return base.identity(dim)
    return identity


def _scale(base, dim, mod):
    def scale(factor):
        # a Vector carries its own per-axis factors; a scalar needs dim
        if isinstance(factor, mod.Vector):
            return base.scale(factor)
        return base.scale(dim, factor)
    return scale


# type name -> (treat 2+ positional args as one coordinate sequence?,
#               static methods that also need the dimension curried)
_CURRIED_TYPES = {
    "Vector": (True, {"axis": _axis}),
    "Matrix": (True, {"identity": _identity, "scale": _scale}),
    "Camera": (False, {}),
    "BoxScene": (False, {}),
    "AABB": (False, {}),
}

# names re-exported from the tracer module unchanged (the dimension is
# either irrelevant or carried by their arguments)
_REEXPORTS = (
    "CompositeScene", "KDNode", "KDLeaf", "KDBranch", "Primitive",
    "PrimitiveBatch", "PrimitivePrototype", "Solid", "SolidPrototype",
    "Triangle", "TriangleBatch", "TrianglePrototype",
    "TriangleBatchPrototype", "PointLight", "GlobalLight", "dot", "cross",
    "build_kdtree", "build_composite_scene", "screen_coord_to_ray",
    "BATCH_SIZE",
)


def _curry_dimension(mod, name, dim):
    """Build a subclass of ``mod.<name>`` whose every construction route
    fills in the leading ``dimension`` argument.  ``__new__`` returns a
    base-class instance, so the subclass never actually instantiates —
    it exists only to intercept the constructor and curried statics."""
    base = getattr(mod, name)
    seq_varargs, statics = _CURRIED_TYPES[name]

    def __new__(cls, *args, **kwds):
        if seq_varargs and len(args) > 1:
            # Vector(1, 2, 3) sugar for Vector((1, 2, 3))
            return base(dim, args, **kwds)
        return base(dim, *args, **kwds)

    ns = {"__new__": __new__, "__slots__": ()}
    for sname, make in statics.items():
        ns[sname] = staticmethod(make(base, dim, mod))
    return type(name, (base,), ns)


class NTracer:
    """Per-dimension facade over the tracer modules.

    ``NTracer(d)`` resolves the specialized module for dimension ``d``
    (here specialization happens in the engine's kernels, so tracer3..tracer8
    are shims over tracern) and exposes its API with the dimension
    pre-applied.  Instances are cached per dimension (weakly, so unused
    facades can be collected); ``force_generic=True`` bypasses the cache
    and the specialized modules — kept for reference API compatibility
    and exercised by the generic-path tests.
    """

    _cache = weakref.WeakValueDictionary()

    def __new__(cls, dimension, force_generic=False):
        cached = None if force_generic else NTracer._cache.get(dimension)
        if cached is not None:
            return cached

        self = object.__new__(cls)
        if force_generic:
            mod = importlib.import_module("ntracer_tpu_torch.tracern")
        else:
            mod = _render.get_optimized_tracern(dimension)

        self.dimension = dimension
        self.base = mod
        for name in _CURRIED_TYPES:
            setattr(self, name, _curry_dimension(mod, name, dimension))
        for name in _REEXPORTS:
            setattr(self, name, getattr(mod, name))

        if not force_generic:
            NTracer._cache[dimension] = self
        return self
