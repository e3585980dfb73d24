"""``ntracer.render`` equivalent of the PyTorch port: the scene-independent
types and the renderer.

The Python API surface of the reference's ``render`` extension module
(src/render.cpp): ``Color``, ``Material``, ``Channel``, ``ImageFormat``,
``ChannelList``, ``Scene``, ``LockedError``, ``BlockingRenderer``,
``CallbackRenderer``, ``get_optimized_tracern`` and the ``_*_unpickle``
functions -- the port's own copy of ``ntracer_tpu/render.py``'s host types
(numpy only).

The renderers keep the same host-visible contract as the JAX package's: a
blocking render returns False when aborted, the scene is locked while a
render is in flight, a second concurrent render on one blocking renderer
raises, and a callback renderer queues frames in FIFO order.  Frames run on
the renderer's device: ``"cuda"`` by default, ``"cpu"`` for the plain-torch
path.  There is no fallback from one device to another.
"""

from __future__ import annotations

import importlib
import threading
import traceback

import numpy as np
import torch

from ._codec import encode_floats, decode_floats

f32 = np.float32

__all__ = [
    "Color", "Material", "Channel", "ImageFormat", "ChannelList", "Scene",
    "LockedError", "BlockingRenderer", "CallbackRenderer",
    "get_optimized_tracern",
]

# largest channel bit size that fits a portable long (render.cpp:47)
MAX_BITSIZE = 31
# largest pixel size in bytes (render.cpp:50)
MAX_PIXELSIZE = 16

DEFAULT_SPECULAR_EXP = 8


class LockedError(RuntimeError):
    """Raised when modifying a scene that is being rendered
    (render.cpp:1326-1336)."""

    def __str__(self):
        if not self.args:
            return "scene is locked"
        return super().__str__()


class Color:
    """Immutable RGB color with float32 components (light.hpp:4-110,
    render.cpp:969-1152)."""

    __slots__ = ("_v",)

    def __init__(self, r, g, b):
        v = np.empty(3, dtype=f32)
        v[0] = r
        v[1] = g
        v[2] = b
        v.flags.writeable = False
        object.__setattr__(self, "_v", v)

    @classmethod
    def _from_array(cls, a):
        self = object.__new__(cls)
        v = np.asarray(a, dtype=f32).reshape(3).copy()
        v.flags.writeable = False
        object.__setattr__(self, "_v", v)
        return self

    @property
    def r(self):
        return float(self._v[0])

    @property
    def g(self):
        return float(self._v[1])

    @property
    def b(self):
        return float(self._v[2])

    def __len__(self):
        return 3

    def __getitem__(self, i):
        if isinstance(i, slice):
            raise TypeError("color index must be an integer")
        i = int(i)
        if i < 0 or i >= 3:
            raise IndexError("color index out of range")
        return float(self._v[i])

    def __iter__(self):
        return (float(x) for x in self._v)

    def __buffer__(self, flags):
        return memoryview(self._v)

    def __eq__(self, b):
        if isinstance(b, Color):
            return bool(np.all(self._v == b._v))
        return NotImplemented

    def __ne__(self, b):
        if isinstance(b, Color):
            return bool(np.any(self._v != b._v))
        return NotImplemented

    def __hash__(self):
        return hash(self._v.tobytes())

    def __add__(self, b):
        if isinstance(b, Color):
            return Color._from_array(self._v + b._v)
        return NotImplemented

    def __sub__(self, b):
        if isinstance(b, Color):
            return Color._from_array(self._v - b._v)
        return NotImplemented

    def __mul__(self, b):
        if isinstance(b, Color):
            return Color._from_array(self._v * b._v)
        if isinstance(b, (int, float, np.floating, np.integer)):
            return Color._from_array(self._v * f32(b))
        return NotImplemented

    def __rmul__(self, b):
        if isinstance(b, (int, float, np.floating, np.integer)):
            return Color._from_array(f32(b) * self._v)
        return NotImplemented

    def __truediv__(self, b):
        if isinstance(b, Color):
            return Color._from_array(self._v / b._v)
        if isinstance(b, (int, float, np.floating, np.integer)):
            return Color._from_array(self._v / f32(b))
        return NotImplemented

    def __neg__(self):
        return Color._from_array(-self._v)

    def apply(self, func):
        return Color(func(self.r), func(self.g), func(self.b))

    def __repr__(self):
        return "Color({!r},{!r},{!r})".format(self.r, self.g, self.b)

    def __reduce__(self):
        return _color_unpickle, (encode_floats(self._v),)

    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self


def read_color(x) -> Color:
    """Accept a Color or a 3-tuple (render.cpp:1182-1195)."""
    if isinstance(x, Color):
        return x
    t = tuple(x)
    if len(t) != 3:
        raise ValueError("object must have exactly 3 values")
    return Color(*t)


class Material:
    """Surface material (py_common.hpp material + render.cpp:1166-1323).

    ``Material(color, opacity=1, reflectivity=0, specular_intensity=1,
    specular_exp=8, specular_color=(1,1,1))``
    """

    def __init__(self, color, opacity=1.0, reflectivity=0.0,
                 specular_intensity=1.0, specular_exp=DEFAULT_SPECULAR_EXP,
                 specular_color=(1.0, 1.0, 1.0)):
        self._c = read_color(color)
        self._specular = read_color(specular_color)
        self.opacity = float(opacity)
        self.reflectivity = float(reflectivity)
        self.specular_intensity = float(specular_intensity)
        self.specular_exp = float(specular_exp)

    @property
    def color(self):
        return self._c

    @property
    def specular(self):
        return self._specular

    @specular.setter
    def specular(self, value):
        self._specular = read_color(value)

    def __repr__(self):
        c, s = self._c, self._specular
        return ("Material(({!r},{!r},{!r}),{!r},{!r},{!r},{!r},({!r},{!r},{!r}))"
                .format(c.r, c.g, c.b, self.opacity, self.reflectivity,
                        self.specular_intensity, self.specular_exp,
                        s.r, s.g, s.b))

    def __reduce__(self):
        data = encode_floats(np.concatenate([
            np.asarray(list(self._c), dtype=f32),
            np.asarray(list(self._specular), dtype=f32),
            np.asarray([self.opacity, self.reflectivity,
                        self.specular_intensity, self.specular_exp], dtype=f32),
        ]))
        return _material_unpickle, (data,)

    def __copy__(self):
        return Material(self._c, self.opacity, self.reflectivity,
                        self.specular_intensity, self.specular_exp,
                        self._specular)

    def __deepcopy__(self, memo):
        return self.__copy__()


class Channel:
    """One packed output channel (render.cpp:95-164).

    ``Channel(bit_size, f_r, f_g, f_b, f_c=0, tfloat=False)`` — the written
    value is ``clamp(f_r*r + f_g*g + f_b*b + f_c, 0, 1)`` scaled to
    ``bit_size`` bits (or stored as a raw float32 when ``tfloat``).
    """

    __slots__ = ("bit_size", "f_r", "f_g", "f_b", "f_c", "tfloat")

    def __init__(self, bit_size, f_r, f_g, f_b, f_c=0.0, tfloat=False):
        bit_size = int(bit_size)
        tfloat = bool(tfloat)
        if tfloat:
            if bit_size != 32:
                raise ValueError('if "tfloat" is true, "bit_size" can only be 32')
        else:
            if bit_size > MAX_BITSIZE:
                raise ValueError(
                    f'"bit_size" cannot be greater than {MAX_BITSIZE} (unless "tfloat" is true)')
            if bit_size < 1:
                raise ValueError('"bit_size" cannot be less than 1')
        object.__setattr__(self, "bit_size", bit_size)
        object.__setattr__(self, "f_r", float(np.float32(f_r)))
        object.__setattr__(self, "f_g", float(np.float32(f_g)))
        object.__setattr__(self, "f_b", float(np.float32(f_b)))
        object.__setattr__(self, "f_c", float(np.float32(f_c)))
        object.__setattr__(self, "tfloat", tfloat)

    def __setattr__(self, name, value):
        raise AttributeError("Channel attributes are read-only")

    def __eq__(self, other):
        if isinstance(other, Channel):
            return all(getattr(self, n) == getattr(other, n) for n in self.__slots__)
        return NotImplemented

    def __hash__(self):
        return hash(tuple(getattr(self, n) for n in self.__slots__))

    def __repr__(self):
        return (f"Channel({self.bit_size},{self.f_r},{self.f_g},{self.f_b},"
                f"{self.f_c},{self.tfloat})")


class ChannelList:
    """Read-only sequence view of an ImageFormat's channels
    (render.cpp:176-321)."""

    def __init__(self, parent):
        self._parent = parent

    def __len__(self):
        return len(self._parent._channels)

    def __getitem__(self, i):
        if isinstance(i, slice):
            raise TypeError("index must be an integer")
        i = int(i)
        if i < 0 or i >= len(self._parent._channels):
            raise IndexError("index out of range")
        return self._parent._channels[i]

    def __iter__(self):
        return iter(tuple(self._parent._channels))


class ImageFormat:
    """Pixel layout of an output buffer (render.cpp:167-288)."""

    def __init__(self, width, height, channels, pitch=0, reversed=False):
        self.width = int(width)
        self.height = int(height)
        self.reversed = bool(reversed)
        self._channels = []
        self._bytes_per_pixel = 0
        self.set_channels(channels)

        if self.width < 1 or self.height < 1:
            raise ValueError("width and height must be at least 1")
        pitch = int(pitch)
        if pitch < 0:
            raise ValueError("pitch cannot be negative")
        if pitch:
            if pitch < self.width * self._bytes_per_pixel:
                raise ValueError('"pitch" must be at least "width" times the '
                                 'size of one pixel in bytes')
            self.pitch = pitch
        else:
            self.pitch = self.width * self._bytes_per_pixel

    def set_channels(self, channels):
        chans = []
        bits = 0
        for c in channels:
            if not isinstance(c, Channel):
                raise TypeError("channels must be Channel instances")
            bits += c.bit_size
            chans.append(c)
        if bits > MAX_PIXELSIZE * 8:
            raise ValueError(f"Too many bytes per pixel. The maximum is {MAX_PIXELSIZE}.")
        self._channels = chans
        self._bytes_per_pixel = (bits + 7) // 8

    @property
    def channels(self):
        return ChannelList(self)

    @property
    def bytes_per_pixel(self):
        return self._bytes_per_pixel


def _check_buffer_size(fmt: ImageFormat, buff) -> None:
    if fmt.pitch < fmt.width * fmt.bytes_per_pixel:
        raise ValueError('invalid image format: "pitch" must be at least '
                         '"width" times the pixel size in bytes')
    if buff.nbytes < fmt.pitch * fmt.height:
        raise ValueError("the buffer is too small for an image with the given dimensions")


class Scene:
    """Abstract scene (render.hpp:8-26, render.cpp:586-630).

    Concrete scenes (``BoxScene``, ``CompositeScene``) render through the
    torch engine and carry a scalar oracle path; ``calculate_color`` runs
    one pixel through the oracle.
    """

    def __init__(self):
        self._locked = 0

    # --- locking (tracer.hpp:1922-1926; every mutator calls _ensure_unlocked)
    def _lock(self):
        self._locked += 1

    def _unlock(self):
        assert self._locked
        self._locked -= 1

    @property
    def locked(self):
        return bool(self._locked)

    def _ensure_unlocked(self):
        if self._locked:
            raise LockedError()

    # --- interface used by renderers
    def _set_view_size(self, w, h):
        raise NotImplementedError

    def calculate_color(self, x, y, width, height):
        raise NotImplementedError

    def _render_strip(self, fmt: ImageFormat, y0: int, nrows: int,
                      device="cuda") -> np.ndarray:
        """Render ``nrows`` rows starting at ``y0`` on ``device``; returns
        (nrows, W, 3) f32."""
        raise NotImplementedError


# --------------------------------------------------------------------------
# Renderers (render.cpp:651-966).  The whole frame is one device pass, cut
# into the JAX package's slabs; abort is polled before the dispatch and
# before each slab's pull.
# --------------------------------------------------------------------------

def _resolve_device(device):
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch finds no CUDA device")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device


class _RendererBase:
    def __init__(self, device="cuda"):
        self._device = _resolve_device(device)
        self._mut = threading.Lock()
        self._busy = False
        self._abort = False

    @property
    def device(self):
        return self._device

    def _draw(self, dest, fmt: ImageFormat, sc: Scene) -> bool:
        """Render into dest buffer; returns False if aborted (polled before
        the dispatch and before each slab's pull)."""
        from .engine import wavefront

        view = _byte_view(dest, fmt)
        return wavefront.render_packed(sc, fmt, view, lambda: self._abort,
                                       self._device)


def _byte_view(dest, fmt):
    """A writable byte view of ``dest``, large enough for a frame of
    ``fmt``."""
    view = memoryview(dest)
    if view.readonly:
        raise BufferError("buffer is not writable")
    view = view.cast("B")
    _check_buffer_size(fmt, view)
    return view


class BlockingRenderer(_RendererBase):
    """Synchronous frame renderer (render.cpp:769-966)."""

    def __init__(self, threads=-1, device="cuda"):
        super().__init__(device)
        self._threads = threads  # accepted for API compatibility

    def render(self, dest, format, scene):
        with self._mut:
            if self._busy:
                raise RuntimeError("the renderer is already running")
            self._busy = True
            self._abort = False
        scene._lock()
        try:
            finished = self._draw(dest, format, scene)
        finally:
            scene._unlock()
            with self._mut:
                self._busy = False
                self._abort = False
        return finished

    def signal_abort(self):
        self._abort = True


class CallbackRenderer(_RendererBase):
    """Asynchronous frame renderer (render.cpp:651-766): ``begin_render``
    returns after the device dispatch, and a worker thread calls
    ``callback(renderer)`` once the frame's bytes are in the buffer.

    Several frames may be in flight; they complete and are called back in
    FIFO order.  As in the JAX package, the scene is locked only for the
    dispatch, which captures all scene state (geometry, camera, config): a
    change made to the scene after ``begin_render`` returns does not reach
    the frame in flight, so an animation loop can dispatch frame N+1 with
    a moved camera while frame N's bytes are pulled.  On the card each
    slab's pull runs on a copy stream that waits only for its own frame
    (``wavefront._to_host``)."""

    def __init__(self, threads=0, device="cuda"):
        super().__init__(device)
        self._threads = threads  # accepted for API compatibility
        self._worker = None
        self._done = threading.Condition(self._mut)
        self._queue = []
        self._jobs = 0

    def begin_render(self, dest, format, scene, callback):
        from .engine import wavefront

        view = _byte_view(dest, format)
        scene._lock()
        try:
            slabs = wavefront.dispatch_packed(scene, format, self._device)
        finally:
            scene._unlock()

        with self._mut:
            self._busy = True
            self._jobs += 1
            self._queue.append((slabs, view, format, callback))
            if self._worker is None:
                self._worker = threading.Thread(target=self._run, daemon=True)
                self._worker.start()
            self._done.notify_all()

    def _run(self):
        # one persistent pull worker, parked on the condition between jobs
        # (the reference parks its workers the same way, render.cpp:495-563)
        from .engine import wavefront
        while True:
            with self._mut:
                while not self._queue:
                    self._busy = False
                    self._done.wait()
                slabs, view, fmt, callback = self._queue.pop(0)
            try:
                ok = False
                try:
                    ok = wavefront.pull_packed(slabs, fmt, view,
                                               lambda: self._abort)
                except Exception:
                    # a failed pull must not end the worker: later frames
                    # and abort_render's waiters depend on it (the
                    # reference prints a worker's exception and carries
                    # on, render.cpp:538-541); the frame gets no callback
                    traceback.print_exc()
                if ok:
                    # the callback runs before the job count drops, so
                    # abort_render's wait covers it
                    try:
                        callback(self)
                    except Exception:
                        traceback.print_exc()
            finally:
                with self._mut:
                    self._jobs -= 1
                    if not self._jobs:
                        self._done.notify_all()

    def abort_render(self):
        """Abort the frames in flight and wait until none is left.  From
        inside a callback, drop the queued frames and return: the running
        job ends only after its callback returns."""
        if threading.current_thread() is self._worker:
            with self._mut:
                self._jobs -= len(self._queue)
                self._queue.clear()
            return
        with self._mut:
            if self._jobs:
                self._abort = True
                while self._jobs:
                    self._done.wait()
            self._abort = False


# --------------------------------------------------------------------------
# Per-dimension tracer module lookup (render.cpp:1345-1382, 1660-1664)
# --------------------------------------------------------------------------

def get_optimized_tracern(dimension):
    """Return the specialized ``tracer{d}`` module when it exists, else the
    generic ``tracern``."""
    dimension = int(dimension)
    if dimension < 3:
        raise ValueError("dimension cannot be less than 3")
    try:
        return importlib.import_module(f"ntracer_tpu_torch.tracer{dimension}")
    except ImportError:
        return importlib.import_module("ntracer_tpu_torch.tracern")


# --------------------------------------------------------------------------
# Unpickle functions (render.cpp:1482-1656).  Byte layouts are identical to
# the reference's.  The helpers keep their own module path
# (``ntracer_tpu_torch.render``), so an object of this package unpickles to
# an object of this package.
# --------------------------------------------------------------------------

def _color_unpickle(data):
    return Color._from_array(decode_floats(data, 3))


def _material_unpickle(data):
    v = decode_floats(data, 10)
    m = Material(Color._from_array(v[0:3]), float(v[6]), float(v[7]),
                 float(v[8]), float(v[9]), Color._from_array(v[3:6]))
    return m


def _tracer_mod(dim):
    return get_optimized_tracern(dim)


def _vector_unpickle(dim, data):
    mod = _tracer_mod(dim)
    return mod.Vector(dim, decode_floats(data, dim))


def _matrix_unpickle(dim, data):
    mod = _tracer_mod(dim)
    return mod.Matrix(dim, decode_floats(data, dim * dim).reshape(dim, dim))


def _triangle_unpickle(dim, values, material):
    mod = _tracer_mod(dim)
    rows = decode_floats(values, (dim + 1) * dim).reshape(dim + 1, dim)
    return mod.Triangle(rows[0], rows[1], rows[2:], material)


def _triangle_batch_unpickle(batch_size, dim, values, *materials):
    mod = _tracer_mod(dim)
    if batch_size != mod.BATCH_SIZE:
        raise ValueError(
            "this triangle batch was created for a batch size of "
            f"{batch_size}, but this build uses a batch size of {mod.BATCH_SIZE}")
    rows = decode_floats(values, (dim + 1) * batch_size * dim)
    rows = rows.reshape(dim + 1, batch_size, dim)
    tris = [mod.Triangle(rows[0, i], rows[1, i], rows[2:, i], materials[i])
            for i in range(batch_size)]
    return mod.TriangleBatch(tris)


def _solid_unpickle(dim, values, material):
    mod = _tracer_mod(dim)
    stype = values[0]
    if isinstance(stype, str):
        stype = ord(stype)
    floats = decode_floats(values[1:], dim * dim + dim)
    orientation = floats[:dim * dim].reshape(dim, dim)
    position = floats[dim * dim:]
    return mod.Solid(int(stype), mod.Vector(dim, position),
                     mod.Matrix(dim, orientation), material)


def _aabb_unpickle(dim, values):
    mod = _tracer_mod(dim)
    floats = decode_floats(values, dim * 2)
    return mod.AABB(dim, floats[:dim], floats[dim:])
