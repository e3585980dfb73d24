"""Scenes: ``BoxScene``, ``CompositeScene``, builders, and the shading oracle.

The scalar shading path is an exact port of composite_scene
(src/tracer.hpp:1710-1927): ``aabb_distance`` 1892-1918,
``light_reaches`` 1750-1766, ``base_color`` 1768-1854, ``ray_color``
1856-1883, ``calculate_color`` 1885-1890; box_scene 83-123.  It backs
``Scene.calculate_color`` (the single-pixel CPU entry the tests use); frames
render through the torch engine, which is validated against this oracle.
"""

from __future__ import annotations

import numpy as np

from . import _vecmath as vm
from . import kdtree
from . import tracing
from .api import Vector, Camera, AABB, _vector_arg, _RaySource, check_dimension
from .kdnodes import (KDNode, KDLeaf, KDBranch, _SkipTarget, _TraversalState,
                      _intersects, _occludes, _safe_inv)
from .primitives import (PrimitivePrototype, RayIntersection, PointLight,
                         GlobalLight, hypercube_intersects_raw)
from .render import Scene, Color, read_color

f32 = np.float32
REAL_MAX = f32(np.finfo(np.float32).max)

# point lights dimmer than this are skipped (tracer.hpp:31)
LIGHT_THRESHOLD = f32(1) / f32(512)

DEFAULT_BG_GRADIENT_AXIS = 1


def _sort_unique(hits):
    """quick_list::sort_and_unique — sort by dist, drop adjacent duplicates
    of the same target (tracer.hpp:714-721)."""
    hits.sort(key=lambda h: h[0])
    out = []
    for h in hits:
        if out and out[-1][3] is h[3] and out[-1][4] == h[4]:
            continue
        out.append(h)
    return out


class BoxScene(Scene):
    """Unit hypercube demo scene (tracer.hpp:83-123)."""

    def __init__(self, dimension):
        super().__init__()
        d = check_dimension(dimension)
        self.fov = 0.8
        self._cam = Camera(d)
        self._src = None
        self._version = 0

    @property
    def dimension(self):
        return self._cam.dimension

    def set_camera(self, camera):
        self._ensure_unlocked()
        if camera.dimension != self.dimension:
            raise TypeError("the scene and camera must have the same dimension")
        self._cam = camera.__copy__()
        self._cam_version = getattr(self, "_cam_version", 0) + 1

    def get_camera(self):
        return self._cam.__copy__()

    def set_fov(self, fov):
        self._ensure_unlocked()
        self.fov = float(fov)
        self._version += 1

    def _set_view_size(self, w, h):
        self._src = _RaySource(w, h, self.fov)

    def calculate_color(self, x, y, width, height):
        self._set_view_size(width, height)
        return Color._from_array(self._pixel_color(x, y))

    def _pixel_color(self, x, y):
        """tracer.hpp:101-114."""
        o = self._cam._origin
        dvec = self._src(self._cam, f32(x), f32(y))
        hit = hypercube_intersects_raw(o, dvec)
        if hit is not None:
            _, _, n = hit
            sine = vm.dot(dvec, n)
            v = -sine if sine <= 0 else f32(0)
            return np.asarray([v, v * f32(0.5), v * f32(0.5)], dtype=f32)
        intensity = dvec[0]
        if intensity > 0:
            return np.asarray([intensity] * 3, dtype=f32)
        return np.asarray([0, -intensity, -intensity], dtype=f32)

    def _render_strip(self, fmt, y0, nrows, device="cuda"):
        """Float colors of rows ``y0`` .. ``y0 + nrows - 1`` of the frame
        ``fmt`` describes, rendered on ``device``: (nrows, W, 3) float32."""
        from .engine import wavefront
        return wavefront.render_strip_box(self, fmt, y0, nrows, device)


class _LightList:
    """Sequence view over a scene's lights (ntracer_body.hpp:620-630:
    ``PointLightList``/``GlobalLightList``): mutations go through the
    scene's lock discipline and invalidate its device cache."""

    _item_type = None

    def __init__(self, scene, items):
        self._scene = scene
        self._items = items

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __iter__(self):
        return iter(self._items)

    def _check(self, light):
        if not isinstance(light, self._item_type):
            raise TypeError("object must be an instance of "
                            + self._item_type.__name__)
        if light.dimension != self._scene.dimension:
            raise TypeError(
                "the light must have the same dimension as the scene")

    def _norm_index(self, i):
        if i < 0:
            i += len(self._items)
        if not 0 <= i < len(self._items):
            raise IndexError("index out of range")
        return i

    def __setitem__(self, i, light):
        # cs_light_list_setitem (ntracer_body.hpp:3131-3146): the LOCK
        # check comes first, then index/type validation, then replacement
        self._scene._ensure_unlocked()
        i = self._norm_index(i)
        self._check(light)
        self._scene._mutate()
        self._items[i] = light

    def __delitem__(self, i):
        # deletion swaps with the last element then pops (the reference's
        # sq_ass_item with value=NULL, ntracer_body.hpp:3142-3144)
        self._scene._ensure_unlocked()
        i = self._norm_index(i)
        self._scene._mutate()
        if i != len(self._items) - 1:
            self._items[i] = self._items[-1]
        self._items.pop()

    def append(self, light):
        # cs_light_list_append: ensure_unlocked precedes the type check
        self._scene._ensure_unlocked()
        self._check(light)
        self._scene._mutate()
        self._items.append(light)

    def extend(self, lights):
        for li in lights:
            self.append(li)

    def __repr__(self):
        return f"<{type(self).__name__} {self._items!r}>"


class PointLightList(_LightList):
    _item_type = PointLight


class GlobalLightList(_LightList):
    _item_type = GlobalLight


class CompositeScene(Scene):
    """K-d tree scene with lights, shadows, reflections and transparency
    (tracer.hpp:1710-1927)."""

    def __init__(self, boundary, data):
        super().__init__()
        if not isinstance(boundary, AABB):
            raise TypeError("boundary must be an AABB")
        if data is not None and not isinstance(data, KDNode):
            raise TypeError("data must be a KDNode or None")
        d = boundary.dimension
        self._boundary = boundary
        self._root = data
        self.shadows = False
        self.camera_light = True
        self.fov = 0.8
        self.max_reflect_depth = 4
        self.bg_gradient_axis = DEFAULT_BG_GRADIENT_AXIS
        self.ambient = Color(0, 0, 0)
        self.bg1 = Color(1, 1, 1)
        self.bg2 = Color(0, 0, 0)
        self.bg3 = Color(0, 1, 1)
        self._cam = Camera(d)
        self._point_lights = []
        self._global_lights = []
        self._src = None
        self._version = 0
        self._torch_cache = None
        self._torch_mesh_cache = None

    # --- config API (ntracer_body.hpp:833-933) -----------------------------
    @property
    def dimension(self):
        return self._boundary.dimension

    @property
    def boundary(self):
        return self._boundary

    @property
    def root(self):
        return self._root

    @property
    def ambient_color(self):
        return self.ambient

    def _mutate(self):
        """Geometry/light mutation: invalidates the flattened device arrays."""
        self._ensure_unlocked()
        self._version += 1
        self._torch_cache = None
        self._torch_mesh_cache = None

    def _mutate_config(self):
        """Config-only mutation (camera, fov, flags): device arrays stay
        valid — config is re-read from the scene on every frame."""
        self._ensure_unlocked()
        self._version += 1

    def _mutate_camera(self):
        """Camera-only mutation: bumps its own version so the per-frame
        camera tensors can be refreshed without a config rebuild — orbit
        animations call set_camera every frame."""
        self._ensure_unlocked()
        self._cam_version = getattr(self, "_cam_version", 0) + 1

    def set_camera(self, camera):
        self._mutate_camera()
        if camera.dimension != self.dimension:
            raise TypeError("the scene and camera must have the same dimension")
        self._cam = camera.__copy__()

    def get_camera(self):
        return self._cam.__copy__()

    def set_fov(self, fov):
        self._mutate_config()
        self.fov = float(fov)

    def set_max_reflect_depth(self, depth):
        self._mutate_config()
        depth = int(depth)
        if depth < 0:
            raise ValueError("max_reflect_depth cannot be negative")
        self.max_reflect_depth = depth

    def set_shadows(self, value):
        self._mutate_config()
        self.shadows = bool(value)

    def set_camera_light(self, value):
        self._mutate_config()
        self.camera_light = bool(value)

    def set_ambient_color(self, color):
        self._mutate_config()
        self.ambient = read_color(color)

    def set_background(self, c1, c2=None, c3=None, axis=None):
        self._mutate_config()
        c1 = read_color(c1)
        c2 = read_color(c2) if c2 is not None else c1
        c3 = read_color(c3) if c3 is not None else c1
        if axis is None:
            axis = DEFAULT_BG_GRADIENT_AXIS
        axis = int(axis)
        if axis < 0 or axis >= self.dimension:
            raise ValueError('"axis" must be between 0 and one less than the '
                             'dimension of the scene')
        self.bg1, self.bg2, self.bg3 = c1, c2, c3
        self.bg_gradient_axis = axis

    def add_light(self, light):
        self._mutate()
        if isinstance(light, PointLight):
            if light.dimension != self.dimension:
                raise TypeError("the light must have the same dimension as the scene")
            self._point_lights.append(light)
        elif isinstance(light, GlobalLight):
            if light.dimension != self.dimension:
                raise TypeError("the light must have the same dimension as the scene")
            self._global_lights.append(light)
        else:
            raise TypeError("object must be an instance of PointLight or GlobalLight")

    @property
    def point_lights(self):
        return PointLightList(self, self._point_lights)

    @property
    def global_lights(self):
        return GlobalLightList(self, self._global_lights)

    # --- scalar oracle ------------------------------------------------------
    def _set_view_size(self, w, h):
        self._src = _RaySource(w, h, self.fov)

    def calculate_color(self, x, y, width, height):
        self._set_view_size(width, height)
        return Color._from_array(self._pixel_color(x, y))

    def _pixel_color(self, x, y):
        o = self._cam._origin
        dvec = self._src(self._cam, f32(x), f32(y))
        return self._ray_color(o, dvec, 0, _SkipTarget(None, -1))

    def _aabb_distance(self, o, dvec):
        """tracer.hpp:1892-1918."""
        d = self.dimension
        bs = self._boundary._start
        be = self._boundary._end
        for i in range(d):
            if dvec[i]:
                oo = bs[i] if dvec[i] > 0 else be[i]
                dist = (oo - o[i]) / dvec[i]
                skip = i
                if dist < 0:
                    dist = f32(0)
                    skip = -1
                ok = True
                for j in range(d):
                    if j != skip:
                        v = dvec[j] * dist + o[j]
                        if v >= be[j] or v <= bs[j]:
                            ok = False
                            break
                if ok:
                    return dist
        return f32(-1)

    def _light_reaches(self, o, dvec, ldistance, skip):
        """tracer.hpp:1750-1766: returns (reached, filter_color)."""
        hits = []
        if self._root is None:
            return True, np.ones(3, dtype=f32)
        if _occludes(self._root, o, dvec, _safe_inv(dvec), ldistance, skip,
                     hits, f32(0), REAL_MAX):
            return False, None
        filt = np.ones(3, dtype=f32)
        if hits:
            for h in _sort_unique(hits)[::-1]:
                op = _target_material(h[3], h[4]).opacity
                filt *= f32(1) - f32(op)
        return True, filt

    def _base_color(self, o, dvec, hit_point, hit_normal, source, depth):
        """tracer.hpp:1768-1854.  Returns a (3,) float32 color."""
        m = _target_material(source.p, source.index)
        mc = np.asarray(list(m.color), dtype=f32)
        mspec = np.asarray(list(m.specular), dtype=f32)

        light = np.zeros(3, dtype=f32)
        specular = np.zeros(3, dtype=f32)
        spec_a = f32(0)

        for pl in self._point_lights:
            lv = (hit_point - pl._position).astype(f32)
            dist = vm.absolute(lv)
            lv = (lv / dist).astype(f32)
            sine = vm.dot(hit_normal, lv)
            if sine > 0:
                strength = f32(1 / np.power(dist, self.dimension - 1))
                plc = np.asarray(list(pl.color), dtype=f32)
                if self.shadows:
                    if plc.max() * strength * sine > LIGHT_THRESHOLD:
                        reached, filt = self._light_reaches(hit_point, lv,
                                                            dist, source)
                        if reached:
                            filtered = (plc * filt * strength).astype(f32)
                            light += filtered * sine
                            if m.specular_intensity:
                                specular, spec_a = _append_specular(
                                    specular, spec_a, m, mspec, filtered,
                                    dvec, hit_normal, lv)
                else:
                    light += plc * strength * sine

        for gl in self._global_lights:
            sine = -vm.dot(hit_normal, gl._direction)
            if sine > 0:
                glc = np.asarray(list(gl.color), dtype=f32)
                if self.shadows:
                    reached, filt = self._light_reaches(
                        hit_point, (-gl._direction).astype(f32), REAL_MAX,
                        source)
                    if reached:
                        filtered = (glc * filt).astype(f32)
                        light += filtered * sine
                        if m.specular_intensity:
                            specular, spec_a = _append_specular(
                                specular, spec_a, m, mspec, filtered, dvec,
                                hit_normal, (-gl._direction).astype(f32))
                else:
                    light += glc * sine

        sine = -vm.dot(dvec, hit_normal)
        if self.camera_light and sine > 0:
            light += np.asarray([sine, sine, sine], dtype=f32)
            if m.specular_intensity:
                base = f32(np.power(sine, f32(m.specular_exp))
                           * f32(m.specular_intensity))
                specular = specular + mspec * base * (1 - spec_a)
                spec_a = spec_a + base * (1 - spec_a)
                specular = specular * spec_a

        ambient = np.asarray(list(self.ambient), dtype=f32)
        r = ambient + mc * light

        if m.reflectivity and depth < self.max_reflect_depth:
            refl_dir = (dvec - hit_normal * (-2 * sine)).astype(f32)
            child = self._ray_color(hit_point, refl_dir, depth + 1, source)
            refl = f32(m.reflectivity)
            r = mc * child * refl + r * (1 - refl)

        return (specular + r * (1 - spec_a)).astype(f32)

    def _ray_color(self, o, dvec, depth, source):
        """tracer.hpp:1856-1883."""
        st = _TraversalState(o, dvec, source)
        dist = self._aabb_distance(o, dvec)
        did_hit = False
        if dist >= 0 and self._root is not None:
            did_hit = _intersects(self._root, st, dist, REAL_MAX)
        if did_hit:
            r = self._base_color(o, dvec, st.o_point, st.o_normal,
                                 _SkipTarget(st.o_prim, st.o_index), depth)
        else:
            intensity = dvec[self.bg_gradient_axis]
            bg1 = np.asarray(list(self.bg1), dtype=f32)
            bg2 = np.asarray(list(self.bg2), dtype=f32)
            bg3 = np.asarray(list(self.bg3), dtype=f32)
            if intensity >= 0:
                r = bg1 * intensity + bg2 * (1 - intensity)
            else:
                r = bg3 * -intensity + bg2 * (1 + intensity)
            r = r.astype(f32)

        if st.t_hits:
            for h in _sort_unique(st.t_hits)[::-1]:
                tdist, tp, tn, tprim, tidx = h
                m = _target_material(tprim, tidx)
                base = self._base_color(o, dvec, tp, tn,
                                        _SkipTarget(tprim, tidx), depth)
                op = f32(m.opacity)
                r = base * op + r * (1 - op)
        return r.astype(f32)

    def _render_strip(self, fmt, y0, nrows, device="cuda"):
        """Float colors of rows ``y0`` .. ``y0 + nrows - 1`` of the frame
        ``fmt`` describes, rendered on ``device``: (nrows, W, 3) float32."""
        from .engine import wavefront
        return wavefront.render_strip_composite(self, fmt, y0, nrows, device)

    def __copy__(self):
        """Clone the scene: the k-d tree is cloned too (single-parent
        ownership), configuration and lights copied
        (ntracer_body.hpp:1706-1730)."""
        from .kdnodes import _clone
        c = CompositeScene(self._boundary.__copy__(), _clone(self._root))
        c.shadows = self.shadows
        c.camera_light = self.camera_light
        c.fov = self.fov
        c.max_reflect_depth = self.max_reflect_depth
        c.bg_gradient_axis = self.bg_gradient_axis
        c.ambient, c.bg1, c.bg2, c.bg3 = (self.ambient, self.bg1, self.bg2,
                                          self.bg3)
        c._cam = self._cam.__copy__()
        c._point_lights = list(self._point_lights)
        c._global_lights = list(self._global_lights)
        return c

    def __deepcopy__(self, memo):
        return self.__copy__()


def _target_material(prim, index):
    """intersection_target::mat (tracer.hpp:744-763)."""
    if index >= 0:
        return prim._materials[index]
    return prim.material


def _append_specular(specular, spec_a, m, mspec, light_c, target_dir, normal,
                     light_dir):
    """Blinn-Phong specular accumulation (tracer.hpp:1701-1707)."""
    h = (light_dir - target_dir).astype(f32)
    base = f32(np.power(vm.dot(normal, vm.unit(h)), f32(m.specular_exp))
               * f32(m.specular_intensity))
    specular = specular + mspec * light_c * base * (1 - spec_a)
    spec_a = spec_a + base * (1 - spec_a)
    specular = specular * spec_a
    return specular.astype(f32), f32(spec_a)


# ---------------------------------------------------------------------------
# Build functions (ntracer_body.hpp:3251-3345)
# ---------------------------------------------------------------------------

def _build(primitives, extra_threads, max_depth, split_threshold,
           traversal_cost, intersection_cost, update_primitives,
           primitives_arg):
    from .primitives import TrianglePrototypeSequence
    if isinstance(primitives, TrianglePrototypeSequence):
        # lazy batch_from_points output: homogeneous TrianglePrototypes
        # of one dimension by construction — skip the two 300k-object
        # validation loops and keep the sequence lazy for the array
        # fast paths downstream (kdtree.build_tree / group_primitives)
        protos = primitives
        if not len(protos):
            raise ValueError("cannot build tree from empty sequence")
        d = protos.dimension
    else:
        protos = list(primitives)
        if not protos:
            raise ValueError("cannot build tree from empty sequence")
        for p in protos:
            if not isinstance(p, PrimitivePrototype):
                raise TypeError("objects must be PrimitivePrototype instances")
        d = protos[0].dimension
        for p in protos[1:]:
            if p.dimension != d:
                raise TypeError("the primitive prototypes must all have the same dimension")

    if max_depth is not None and int(max_depth) < 0:
        raise ValueError("max_depth cannot be less than 0")
    if split_threshold is not None and int(split_threshold) < 1:
        raise ValueError("split_threshold cannot be less than 1")

    params = kdtree.KDTreeParams(d, max_depth, split_threshold,
                                 traversal_cost, intersection_cost)

    def make_leaf(ps):
        return KDLeaf([p.primitive for p in ps])

    def make_branch(axis, split, left, right):
        return KDBranch(axis, split, left, right)

    # extra_threads: parallel native build (kd_node_worker_pool analogue,
    # tracer.hpp:2131-2271); the NumPy fallback builder is single-threaded
    b_start, b_end, root, grouped = kdtree.build_tree(
        protos, params, make_leaf, make_branch,
        extra_threads=int(extra_threads))

    if update_primitives:
        if not isinstance(primitives_arg, list):
            raise TypeError('"primitives" must be an instance of "list" if '
                            '"update_primitives" is true')
        primitives_arg[:] = grouped

    return b_start, b_end, root


def build_kdtree(primitives, extra_threads=-1, *, max_depth=None,
                 split_threshold=None, traversal_cost=None,
                 intersection_cost=None, update_primitives=False):
    b_start, b_end, root = _build(primitives, extra_threads, max_depth,
                                  split_threshold, traversal_cost,
                                  intersection_cost, update_primitives,
                                  primitives)
    return Vector._wrap(b_start), Vector._wrap(b_end), root


def build_composite_scene(primitives, extra_threads=-1, *, max_depth=None,
                          split_threshold=None, traversal_cost=None,
                          intersection_cost=None, update_primitives=False):
    with tracing.span("scene.kd_build"):
        b_start, b_end, root = _build(primitives, extra_threads, max_depth,
                                      split_threshold, traversal_cost,
                                      intersection_cost, update_primitives,
                                      primitives)
    return CompositeScene(AABB._wrap(b_start, b_end), root)
