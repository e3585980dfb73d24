"""Core n-dimensional geometry API objects (Vector, Matrix, Camera, AABB).

These mirror the per-dimension tracer modules of the reference
(src/ntracer_body.hpp:3433-3463): every constructor takes the
dimension explicitly, like the generic ``tracern`` module; the specialized
``tracer3``..``tracer8`` modules re-export the same classes (the engine's CUDA kernels are
specialized per dimension instead of per-dimension compiled extensions).

Objects are numpy float32 backed.  They are host-side API/build-time objects;
render-time math runs in the torch engine.
"""

from __future__ import annotations

import numpy as np

from . import _vecmath as vm
from ._codec import encode_floats
from .render import (Material, _vector_unpickle, _matrix_unpickle,
                     _aabb_unpickle)

f32 = np.float32

# Matches tracer.hpp:25 — epsilon(float) * 10
ROUNDING_FUZZ = f32(np.finfo(np.float32).eps * 10)

# The API-visible primitive batch width (tracer.hpp v_real::size).  The
# reference uses the SIMD register width (4/8); this package keeps 8.  The
# engine repacks into 128-slot chunks regardless.
BATCH_SIZE = 8


def check_dimension(d):
    d = int(d)
    if d < 3:
        raise ValueError("dimension cannot be less than 3")
    return d


class Vector:
    """Immutable n-dimensional float32 vector (ntracer_body.hpp Vector)."""

    __slots__ = ("_a",)

    def __init__(self, dimension, values=None):
        d = check_dimension(dimension)
        if values is None:
            a = np.zeros(d, dtype=f32)
        else:
            if np.isscalar(values):
                a = np.full(d, values, dtype=f32)
            else:
                a = np.asarray(list(values) if not isinstance(values, np.ndarray)
                               else values, dtype=f32).reshape(-1)
                if a.shape[0] != d:
                    raise TypeError(
                        f"expected {d} values, got {a.shape[0]}")
        a = np.ascontiguousarray(a, dtype=f32)
        a.flags.writeable = False
        object.__setattr__(self, "_a", a)

    @classmethod
    def _wrap(cls, a):
        self = object.__new__(cls)
        a = np.ascontiguousarray(a, dtype=f32)
        a.flags.writeable = False
        object.__setattr__(self, "_a", a)
        return self

    @staticmethod
    def axis(dimension, axis, length=1):
        d = check_dimension(dimension)
        axis = int(axis)
        if axis < 0 or axis >= d:
            raise ValueError('"axis" must be between 0 and one less than "dimension"')
        return Vector._wrap(vm.axis_vector(d, axis, length))

    @property
    def dimension(self):
        return self._a.shape[0]

    def __len__(self):
        return self._a.shape[0]

    def __getitem__(self, i):
        return float(self._a[i])

    def __iter__(self):
        return (float(x) for x in self._a)

    def __buffer__(self, flags):
        return memoryview(self._a)

    def __eq__(self, b):
        if isinstance(b, Vector):
            return self._a.shape == b._a.shape and bool(np.all(self._a == b._a))
        return NotImplemented

    def __ne__(self, b):
        r = self.__eq__(b)
        return NotImplemented if r is NotImplemented else not r

    def __hash__(self):
        return hash(self._a.tobytes())

    def __add__(self, b):
        if isinstance(b, Vector):
            return Vector._wrap(self._a + b._a)
        return NotImplemented

    def __sub__(self, b):
        if isinstance(b, Vector):
            return Vector._wrap(self._a - b._a)
        return NotImplemented

    def __neg__(self):
        return Vector._wrap(-self._a)

    def __mul__(self, b):
        if isinstance(b, (int, float, np.floating, np.integer)):
            return Vector._wrap(self._a * f32(b))
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, b):
        if isinstance(b, (int, float, np.floating, np.integer)):
            return Vector._wrap(self._a / f32(b))
        return NotImplemented

    def square(self):
        return float(vm.square(self._a))

    def absolute(self):
        return float(vm.absolute(self._a))

    def unit(self):
        return Vector._wrap(vm.unit(self._a))

    def apply(self, func):
        return Vector._wrap(np.asarray([func(float(x)) for x in self._a], dtype=f32))

    def set_c(self, index, value):
        a = self._a.copy()
        a[index] = f32(value)
        return Vector._wrap(a)

    def __repr__(self):
        vals = ",".join(repr(float(x)) for x in self._a)
        return f"Vector({self.dimension},[{vals}])"

    def __reduce__(self):
        return _vector_unpickle, (self.dimension, encode_floats(self._a))

    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self

    def numpy(self):
        """The backing (read-only) float32 array (an extension of this package)."""
        return self._a


def _vector_arg(x, d=None) -> np.ndarray:
    """Accept a Vector or any float sequence."""
    if isinstance(x, Vector):
        a = x._a
    else:
        a = np.asarray(list(x) if not isinstance(x, np.ndarray) else x,
                       dtype=f32).reshape(-1)
    if d is not None and a.shape[0] != d:
        raise TypeError(f"expected a vector of dimension {d}")
    return a.astype(f32, copy=False)


class MatrixProxy:
    """Flat read-only view of a matrix's values (row-major), like the
    reference's MatrixProxy (pyobject.hpp obj_array_adapter)."""

    def __init__(self, a):
        self._a = a.reshape(-1)

    def __len__(self):
        return self._a.shape[0]

    def __getitem__(self, i):
        return float(self._a[i])

    def __iter__(self):
        return (float(x) for x in self._a)


class Matrix:
    """Immutable n×n float32 matrix (geometry.hpp:527-844)."""

    __slots__ = ("_m",)

    def __init__(self, dimension, values=None):
        d = check_dimension(dimension)
        if values is None:
            m = np.zeros((d, d), dtype=f32)
        else:
            vals = values
            if not isinstance(vals, np.ndarray):
                vals = list(vals)
                if len(vals) and not np.isscalar(vals[0]) and not isinstance(vals[0], (int, float)):
                    vals = [list(r) for r in vals]
            m = np.asarray(vals, dtype=f32)
            if m.ndim == 1:
                if m.shape[0] != d * d:
                    raise TypeError(f"expected {d*d} values, got {m.shape[0]}")
                m = m.reshape(d, d)
            elif m.shape != (d, d):
                raise TypeError(f"expected a {d}x{d} matrix")
        m = np.ascontiguousarray(m, dtype=f32)
        m.flags.writeable = False
        object.__setattr__(self, "_m", m)

    @classmethod
    def _wrap(cls, m):
        self = object.__new__(cls)
        m = np.ascontiguousarray(m, dtype=f32)
        m.flags.writeable = False
        object.__setattr__(self, "_m", m)
        return self

    @property
    def dimension(self):
        return self._m.shape[0]

    @property
    def values(self):
        return MatrixProxy(self._m)

    def __getitem__(self, i):
        return Vector._wrap(self._m[i])

    def __len__(self):
        return self._m.shape[0]

    def __eq__(self, b):
        if isinstance(b, Matrix):
            return self._m.shape == b._m.shape and bool(np.all(self._m == b._m))
        return NotImplemented

    def __ne__(self, b):
        r = self.__eq__(b)
        return NotImplemented if r is NotImplemented else not r

    def __hash__(self):
        return hash(self._m.tobytes())

    def __mul__(self, b):
        if isinstance(b, Matrix):
            # row-by-column dots, matching matrix::multiply (geometry.hpp:559)
            return Matrix._wrap(_f32_matmul(self._m, b._m))
        if isinstance(b, Vector):
            return Vector._wrap(_f32_matvec(self._m, b._a))
        return NotImplemented

    def mult_transpose(self, b):
        if not isinstance(b, Matrix):
            raise TypeError("argument must be a Matrix")
        return Matrix._wrap(_f32_matmul(self._m, b._m.T))

    @staticmethod
    def rotation(a, b, theta):
        av = _vector_arg(a)
        bv = _vector_arg(b, av.shape[0])
        return Matrix._wrap(vm.rotation_matrix(av, bv, float(theta)))

    @staticmethod
    def scale(*args):
        if len(args) == 1:
            return Matrix._wrap(vm.scale_matrix_vec(_vector_arg(args[0])))
        d, factor = args
        return Matrix._wrap(vm.scale_matrix(check_dimension(d), factor))

    @staticmethod
    def reflection(a):
        return Matrix._wrap(vm.reflection_matrix(_vector_arg(a)))

    @staticmethod
    def identity(dimension):
        return Matrix._wrap(np.eye(check_dimension(dimension), dtype=f32))

    def determinant(self):
        return float(vm.determinant(self._m))

    def inverse(self):
        try:
            return Matrix._wrap(vm.inverse(self._m))
        except ValueError as e:
            raise ValueError(str(e)) from None

    def transpose(self):
        return Matrix._wrap(self._m.T)

    def __repr__(self):
        return f"Matrix({self.dimension},{[list(map(float, r)) for r in self._m]!r})"

    def __reduce__(self):
        return _matrix_unpickle, (self.dimension, encode_floats(self._m))

    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self

    def numpy(self):
        return self._m


def _f32_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(f32) @ b.astype(f32)).astype(f32)


def _f32_matvec(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    return (m.astype(f32) @ v.astype(f32)).astype(f32)


class CameraAxes:
    """Mutable view over a camera's orientation rows (ntracer_body CameraAxes)."""

    def __init__(self, cam):
        self._cam = cam

    def __len__(self):
        return self._cam.dimension

    def __getitem__(self, i):
        return Vector._wrap(self._cam._t[i].copy())

    def __setitem__(self, i, value):
        self._cam._t[i] = _vector_arg(value, self._cam.dimension)

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class Camera:
    """Position + transposed orientation matrix; rows are the axes
    (camera.hpp:7-46)."""

    def __init__(self, dimension):
        d = check_dimension(dimension)
        self._origin = np.zeros(d, dtype=f32)
        self._t = np.eye(d, dtype=f32)

    @property
    def dimension(self):
        return self._origin.shape[0]

    @property
    def origin(self):
        return Vector._wrap(self._origin.copy())

    @origin.setter
    def origin(self, value):
        self._origin = _vector_arg(value, self.dimension).copy()

    @property
    def axes(self):
        return CameraAxes(self)

    def right(self):
        return Vector._wrap(self._t[0].copy())

    def up(self):
        return Vector._wrap(self._t[1].copy())

    def forward(self):
        return Vector._wrap(self._t[2].copy())

    def translate(self, v):
        """Translate along the camera's own axes (camera.hpp:17-19)."""
        tv = _vector_arg(v, self.dimension)
        for i in range(self.dimension):
            self._origin = self._origin + tv[i] * self._t[i]

    def transform(self, m):
        if not isinstance(m, Matrix):
            raise TypeError("argument must be a Matrix")
        self._t = _f32_matmul(self._t, m._m.T)

    def normalize(self):
        self._t = vm.gram_schmidt_normalize(self._t)

    def __copy__(self):
        c = Camera(self.dimension)
        c._origin = self._origin.copy()
        c._t = self._t.copy()
        return c

    def __deepcopy__(self, memo):
        return self.__copy__()


class AABB:
    """Axis-aligned bounding box (tracer.hpp:1327-1356)."""

    __slots__ = ("_start", "_end")

    def __init__(self, dimension, start=None, end=None):
        d = check_dimension(dimension)
        if start is not None:
            s = _vector_arg(start)
            if s.shape[0] != d:
                raise TypeError('"start" has a dimension different from "dimension"')
        else:
            s = np.full(d, np.finfo(np.float32).min, dtype=f32)
        if end is not None:
            e = _vector_arg(end)
            if e.shape[0] != d:
                raise TypeError('"end" has a dimension different from "dimension"')
        else:
            e = np.full(d, np.finfo(np.float32).max, dtype=f32)
        self._start = s.copy()
        self._end = e.copy()

    @classmethod
    def _wrap(cls, start, end):
        self = object.__new__(cls)
        self._start = np.asarray(start, dtype=f32)
        self._end = np.asarray(end, dtype=f32)
        return self

    @property
    def dimension(self):
        return self._start.shape[0]

    @property
    def start(self):
        return Vector._wrap(self._start.copy())

    @property
    def end(self):
        return Vector._wrap(self._end.copy())

    def left(self, axis, split):
        e = self._end.copy()
        e[axis] = f32(split)
        return AABB._wrap(self._start.copy(), e)

    def right(self, axis, split):
        s = self._start.copy()
        s[axis] = f32(split)
        return AABB._wrap(s, self._end.copy())

    def center(self):
        return Vector._wrap(((self._start + self._end) * f32(0.5)).astype(f32))

    def intersects(self, prototype):
        from . import kdtree
        return kdtree.aabb_intersects_prototype(self._start, self._end, prototype)

    def intersects_flat(self, prototype, skip):
        from . import kdtree
        return kdtree.aabb_intersects_flat(self._start, self._end, prototype, int(skip))

    def __repr__(self):
        return (f"AABB({self.dimension},{list(map(float, self._start))!r},"
                f"{list(map(float, self._end))!r})")

    def __reduce__(self):
        return _aabb_unpickle, (
            self.dimension,
            encode_floats(np.concatenate([self._start, self._end])))

    def __copy__(self):
        return AABB._wrap(self._start.copy(), self._end.copy())

    def __deepcopy__(self, memo):
        return self.__copy__()


def dot(a, b):
    """Dot product of two vectors (module function)."""
    av = _vector_arg(a)
    bv = _vector_arg(b, av.shape[0])
    return float(vm.dot(av, bv))


def cross(vs):
    """Generalized cross product of d-1 vectors of dimension d
    (geometry.hpp:858-906)."""
    vl = [(_vector_arg(v)) for v in vs]
    if not vl:
        raise TypeError("argument must contain at least one vector")
    d = vl[0].shape[0]
    arr = np.stack(vl)
    if arr.shape[0] != d - 1:
        raise ValueError(
            f"the cross product of {d}-dimensional vectors requires exactly {d-1} vectors")
    return Vector._wrap(vm.cross(arr))


class _RaySource:
    """flat_origin_ray_source (tracer.hpp:60-76)."""

    __slots__ = ("half_w", "half_h", "fovI")

    def __init__(self, w, h, fov):
        self.half_w = f32(w) / f32(2)
        self.half_h = f32(h) / f32(2)
        self.fovI = f32(np.tan(f32(fov) / f32(2)) / self.half_w)

    def __call__(self, cam: Camera, x, y) -> np.ndarray:
        t = cam._t
        d = (t[2]
             + t[0] * (self.fovI * (f32(x) - self.half_w))
             - t[1] * (self.fovI * (f32(y) - self.half_h))).astype(f32)
        return vm.unit(d)


def screen_coord_to_ray(cam, x, y, w, h, fov):
    """Pinhole ray direction for pixel (x,y) (ntracer_body.hpp:3342-3358)."""
    src = _RaySource(int(w), int(h), float(fov))
    return Vector._wrap(src(cam, f32(x), f32(y)))
