// Native SAH k-d tree builder for ntracer_tpu_torch.
//
// Host-side C++ port of the reference build pipeline (the reference builds
// its tree in C++ too: src/tracer.hpp — find_split
// 1965-2054, create_node 2284-2354, exact AABB/primitive tests 1465-1675).
// The Python front end (ntracer_tpu_torch/kdtree.py) marshals prototypes into
// flat float32 arrays, calls ntr_build via ctypes, and reconstructs the
// Python KD node objects from the flattened output; it falls back to the
// NumPy implementation when this library is unavailable.
//
// All geometry math is float32 to match the framework's `real`.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC kd_builder.cpp -o _ntr_native.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <limits>
#include <thread>
#include <vector>

namespace {

using std::int32_t;

constexpr int KIND_TRI = 0;
constexpr int KIND_CUBE = 1;
constexpr int KIND_SPHERE = 2;

struct Input {
    int n;                      // number of units (prototypes)
    int d;                      // dimension
    const float* b_start;       // (n, d)
    const float* b_end;         // (n, d)
    const int32_t* kind;        // (n,)
    const int32_t* tri_offset;  // (n,) member start (triangle units)
    const int32_t* tri_count;   // (n,)
    const float* pts;           // (members, d, d)  point-major rows
    const float* axes;          // (members, d, d)  edge axes (first + en)
    const float* fnormal;       // (members, d)
    const float* sol_orient;    // (n, d, d)
    const float* sol_inv;       // (n, d, d)
    const float* sol_pos;       // (n, d)
    int max_depth;
    int split_threshold;
    float traversal;
    float intersection;
};

struct Output {
    // flattened nodes: axis < 0 => leaf
    std::vector<int32_t> axis;
    std::vector<float> split;
    std::vector<int32_t> left;
    std::vector<int32_t> right;
    std::vector<int32_t> leaf_start;
    std::vector<int32_t> leaf_count;
    std::vector<int32_t> items;  // concatenated unit indices
};

struct Ctx {
    Input in;
    Output out;
};

inline float dot_d(const float* a, const float* b, int d) {
    float s = 0;
    for (int i = 0; i < d; ++i) s += a[i] * b[i];
    return s;
}

inline float skip_dot(const float* a, const float* b, int d, int skip) {
    float s = 0;
    for (int i = 0; i < d; ++i)
        if (i != skip) s += a[i] * b[i];
    return s;
}

// ---------------------------------------------------------------------------
// Exact AABB / primitive tests (tracer.hpp:1465-1675)
// ---------------------------------------------------------------------------

// single member triangle vs box (tracer.hpp:1465-1512, without the
// prototype-AABB early reject which the caller already applied per unit)
bool tri_member_intersects(const Ctx& c, int m, const float* bs,
                           const float* be) {
    const int d = c.in.d;
    const float* pts = c.in.pts + (size_t)m * d * d;
    const float* axes = c.in.axes + (size_t)m * d * d;
    const float* fn = c.in.fnormal + (size_t)m * d;

    std::vector<float> origin(d), half(d);
    for (int i = 0; i < d; ++i) {
        origin[i] = (bs[i] + be[i]) * 0.5f;
        half[i] = (be[i] - bs[i]) * 0.5f;
    }

    float n_offset = dot_d(fn, pts, d);
    float po = dot_d(origin.data(), fn, d);
    float b_max = 0;
    for (int i = 0; i < d; ++i) b_max += std::fabs(half[i] * fn[i]);
    float b_min = po - b_max;
    b_max += po;
    if (b_max < n_offset || b_min > n_offset) return false;

    for (int a = 0; a < d; ++a) {
        const float* axis = axes + (size_t)a * d;
        for (int j = 0; j < d; ++j) {
            float t_min = std::numeric_limits<float>::max();
            float t_max = std::numeric_limits<float>::lowest();
            for (int p = 0; p < d; ++p) {
                float v = skip_dot(pts + (size_t)p * d, axis, d, j);
                t_min = std::min(t_min, v);
                t_max = std::max(t_max, v);
            }
            float po2 = skip_dot(origin.data(), axis, d, j);
            float b_rad = 0;
            for (int k = 0; k < d; ++k)
                if (k != j) b_rad += std::fabs(half[k] * axis[k]);
            if (b_rad != 0 &&
                (po2 + b_rad <= t_min || po2 - b_rad >= t_max))
                return false;
        }
    }
    return true;
}

// flat-axis variant (tracer.hpp:1514-1541); also lacks the AABB pre-reject
bool tri_member_intersects_flat(const Ctx& c, int m, const float* bs,
                                const float* be, int skip) {
    const int d = c.in.d;
    const float* pts = c.in.pts + (size_t)m * d * d;
    const float* axes = c.in.axes + (size_t)m * d * d;

    std::vector<float> origin(d), half(d);
    for (int i = 0; i < d; ++i) {
        origin[i] = (bs[i] + be[i]) * 0.5f;
        half[i] = (be[i] - bs[i]) * 0.5f;
    }

    for (int a = 0; a < d; ++a) {
        const float* axis = axes + (size_t)a * d;
        int p2 = a ? a : 1;
        float t_max = skip_dot(pts, axis, d, skip);
        float t_min = skip_dot(pts + (size_t)p2 * d, axis, d, skip);
        if (t_min > t_max) std::swap(t_min, t_max);
        float po = skip_dot(origin.data(), axis, d, skip);
        float b_max = 0;
        for (int k = 0; k < d; ++k)
            if (k != skip) b_max += std::fabs(half[k] * axis[k]);
        float b_min = po - b_max;
        b_max += po;
        if (b_max <= t_min || b_min >= t_max) return false;
    }
    return true;
}

// box separating-axis helper for cubes (tracer.hpp:1629-1639)
bool box_axis_test(const Ctx& c, int u, const float* bs, const float* be,
                   const float* axis) {
    const int d = c.in.d;
    const float* pos = c.in.sol_pos + (size_t)u * d;
    const float* orient = c.in.sol_orient + (size_t)u * d * d;
    float a_po = dot_d(pos, axis, d);
    float b_po = 0, b_max = 0;
    for (int i = 0; i < d; ++i) {
        b_po += (bs[i] + be[i]) * 0.5f * axis[i];
        b_max += std::fabs((be[i] - bs[i]) * 0.5f * axis[i]);
    }
    float a_max = 0;
    for (int i = 0; i < d; ++i) {
        // column i of orientation
        float s = 0;
        for (int r = 0; r < d; ++r) s += orient[(size_t)r * d + i] * axis[r];
        a_max += std::fabs(s);
    }
    return b_po + b_max < a_po - a_max || b_po - b_max > a_po + a_max;
}

bool solid_intersects(const Ctx& c, int u, const float* bs, const float* be) {
    const int d = c.in.d;
    const float* pos = c.in.sol_pos + (size_t)u * d;
    const float* orient = c.in.sol_orient + (size_t)u * d * d;
    const float* inv = c.in.sol_inv + (size_t)u * d * d;
    const float* ub_s = c.in.b_start + (size_t)u * d;
    const float* ub_e = c.in.b_end + (size_t)u * d;

    if (c.in.kind[u] == KIND_CUBE) {
        for (int i = 0; i < d; ++i)
            if (be[i] <= ub_s[i] || bs[i] >= ub_e[i]) return false;
        std::vector<float> axis(d);
        for (int i = 0; i < d; ++i) {
            const float* normal = inv + (size_t)i * d;  // row i
            if (box_axis_test(c, u, bs, be, normal)) return false;
            float nsq = dot_d(normal, normal, d);
            for (int j = 0; j < d; ++j) {
                for (int k = 0; k < d; ++k) axis[k] = normal[k] * -normal[j];
                axis[j] += nsq;
                if (box_axis_test(c, u, bs, be, axis.data())) return false;
            }
        }
        return true;
    }

    // sphere (tracer.hpp:1662-1675)
    std::vector<float> center(d), box_p(d), closest(d, 0.0f), comp(d);
    for (int i = 0; i < d; ++i) center[i] = (bs[i] + be[i]) * 0.5f;
    for (int i = 0; i < d; ++i) {
        float s = 0;
        for (int j = 0; j < d; ++j) s += inv[(size_t)i * d + j] * center[j];
        box_p[i] = pos[i] - s;
    }
    for (int i = 0; i < d; ++i) {
        float scale = (be[i] - bs[i]) * 0.5f;
        for (int k = 0; k < d; ++k) comp[k] = orient[(size_t)i * d + k] * scale;
        float t = dot_d(box_p.data(), comp.data(), d) / dot_d(comp.data(), comp.data(), d);
        t = std::max(-1.0f, std::min(1.0f, t));
        for (int k = 0; k < d; ++k) closest[k] += t * comp[k];
    }
    float sq = 0;
    for (int i = 0; i < d; ++i) {
        float v = pos[i] - closest[i];
        sq += v * v;
    }
    return sq < 1.0f;
}

bool unit_intersects(const Ctx& c, int u, const float* bs, const float* be) {
    const int d = c.in.d;
    if (c.in.kind[u] != KIND_TRI) return solid_intersects(c, u, bs, be);
    // prototype-AABB reject (tracer.hpp:1468/1546)
    const float* ub_s = c.in.b_start + (size_t)u * d;
    const float* ub_e = c.in.b_end + (size_t)u * d;
    for (int i = 0; i < d; ++i)
        if (ub_s[i] >= be[i] || ub_e[i] <= bs[i]) return false;
    int off = c.in.tri_offset[u], cnt = c.in.tri_count[u];
    for (int m = off; m < off + cnt; ++m)
        if (tri_member_intersects(c, m, bs, be)) return true;
    return false;
}

bool unit_intersects_flat(const Ctx& c, int u, const float* bs,
                          const float* be, int skip) {
    const int d = c.in.d;
    const float* ub_s = c.in.b_start + (size_t)u * d;
    const float* ub_e = c.in.b_end + (size_t)u * d;
    for (int i = 0; i < d; ++i)
        if (i != skip && (ub_s[i] >= be[i] || ub_e[i] <= bs[i])) return false;
    int off = c.in.tri_offset[u], cnt = c.in.tri_count[u];
    for (int m = off; m < off + cnt; ++m)
        if (tri_member_intersects_flat(c, m, bs, be, skip)) return true;
    return false;
}

// ---------------------------------------------------------------------------
// SAH split search (tracer.hpp:1965-2054)
// ---------------------------------------------------------------------------

bool find_split(const Ctx& c, const float* bs, const float* be, int axis,
                const std::vector<int32_t>& contain,
                const std::vector<int32_t>& overlap, float* pos) {
    const int d = c.in.d;
    float best_cost = std::numeric_limits<float>::max();
    bool found = false;

    float side_area = 1;
    for (int i = 0; i < d; ++i)
        if (i != axis) side_area *= be[i] - bs[i];

    float shaft = 0;
    for (int i = 0; i < d; ++i) {
        if (i == axis) continue;
        float tmp = 1;
        for (int j = 0; j < d; ++j)
            if (j != i && j != axis) tmp *= be[j] - bs[j];
        shaft += tmp;
    }
    float area = side_area + shaft * (be[axis] - bs[axis]);

    size_t n = contain.size() + overlap.size();
    std::vector<float> starts(n), ends(n);
    {
        size_t k = 0;
        for (int32_t u : contain) {
            starts[k] = c.in.b_start[(size_t)u * d + axis];
            ends[k] = c.in.b_end[(size_t)u * d + axis];
            ++k;
        }
        for (int32_t u : overlap) {
            starts[k] = c.in.b_start[(size_t)u * d + axis];
            ends[k] = c.in.b_end[(size_t)u * d + axis];
            ++k;
        }
    }
    std::sort(starts.begin(), starts.end());
    std::sort(ends.begin(), ends.end());

    auto split_cost = [&](size_t l_count, size_t r_count, float split) {
        float sh = shaft * (split - bs[axis]);
        float l_area = side_area + sh;
        float r_area = area - sh;
        return c.in.traversal + c.in.intersection *
            (l_area / area * (float)l_count + r_area / area * (float)r_count);
    };

    size_t il = 1, ir = 0;
    float last_split = starts[0];
    size_t last_il = 0;
    while (il < n) {
        float split = std::min(starts[il], ends[ir]);
        if (split != last_split) {
            if (be[axis] > last_split && last_split > bs[axis]) {
                float cost = split_cost(last_il, n - ir, last_split);
                if (cost < best_cost) {
                    best_cost = cost;
                    *pos = last_split;
                    found = true;
                }
            }
            last_il = il;
            last_split = split;
        }
        if (starts[il] <= ends[ir]) ++il;
        else ++ir;
    }
    while (ir < n) {
        float split = ends[ir];
        if (split != last_split) {
            if (be[axis] > last_split && last_split > bs[axis]) {
                float cost = split_cost(n, n - ir, last_split);
                if (cost < best_cost) {
                    best_cost = cost;
                    *pos = last_split;
                    found = true;
                }
            }
            last_split = split;
        }
        ++ir;
    }

    float compare = (float)n;
    for (int i = 0; i < d; ++i) compare *= be[i] - bs[i];
    return found && best_cost < compare;
}

int best_axis(const float* bs, const float* be, int d) {
    int axis = 0;
    float width = be[0] - bs[0];
    for (int i = 1; i < d; ++i) {
        float w = be[i] - bs[i];
        if (w > width) {
            width = w;
            axis = i;
        }
    }
    return axis;
}

int flat_skip(const Ctx& c, int u) {
    // flat-primitive axis handling (tracer.hpp:2326-2334), triangles only
    if (c.in.kind[u] != KIND_TRI) return -1;
    const int d = c.in.d;
    for (int i = 0; i < d; ++i)
        if (c.in.b_start[(size_t)u * d + i] == c.in.b_end[(size_t)u * d + i])
            return i;
    return -1;
}

bool overlap_intersects(const Ctx& c, int u, const float* bs, const float* be,
                        int skip, int axis, bool right) {
    const int d = c.in.d;
    if (skip < 0) return unit_intersects(c, u, bs, be);
    if (skip == axis) {
        float s = c.in.b_start[(size_t)u * d + axis];
        return right ? s >= bs[axis] : s < be[axis];
    }
    return unit_intersects_flat(c, u, bs, be, skip);
}

// pointer-tree node built (possibly) in parallel, flattened serially
struct BNode {
    int32_t axis = -1;          // < 0 => leaf
    float split = 0;
    BNode* l = nullptr;
    BNode* r = nullptr;
    std::vector<int32_t> items;
    ~BNode() { delete l; delete r; }
};

// bounded thread budget shared by the whole build, mirroring the
// reference's kd_node_worker_pool (tracer.hpp:2131-2271): the left child
// is built on another thread when a slot is free, the right inline, and
// exceptions propagate to the caller.
struct BuildPool {
    std::atomic<int> avail{0};
};

// recursive SAH build (tracer.hpp:2284-2354).  Boxes are taken by value:
// each (possibly concurrent) subtree owns its own copy.
BNode* create_node(const Ctx& c, BuildPool& pool, int depth,
                   std::vector<float> bs, std::vector<float> be,
                   std::vector<int32_t> contain,
                   std::vector<int32_t> overlap) {
    const int d = c.in.d;
    ++depth;
    int axis = best_axis(bs.data(), be.data(), d);
    if (contain.empty() && overlap.empty()) return nullptr;

    float split = 0;
    bool leaf = depth >= c.in.max_depth ||
        (contain.size() + overlap.size() <= (size_t)c.in.split_threshold);
    if (!leaf)
        leaf = !find_split(c, bs.data(), be.data(), axis, contain, overlap,
                           &split);
    if (leaf) {
        BNode* n = new BNode();
        n->items = std::move(contain);
        n->items.insert(n->items.end(), overlap.begin(), overlap.end());
        return n;
    }

    std::vector<int32_t> lc, rc, lo, ro;
    for (int32_t u : contain) {
        float s = c.in.b_start[(size_t)u * d + axis];
        float e = c.in.b_end[(size_t)u * d + axis];
        if (s < split) {
            if (e <= split) lc.push_back(u);
            else {
                lo.push_back(u);
                ro.push_back(u);
            }
        } else rc.push_back(u);
    }

    float orig_s = bs[axis], orig_e = be[axis];
    for (int32_t u : overlap) {
        int skip = flat_skip(c, u);
        be[axis] = split;           // left box
        bool in_left = overlap_intersects(c, u, bs.data(), be.data(), skip,
                                          axis, false);
        be[axis] = orig_e;
        if (in_left) {
            lo.push_back(u);
            bs[axis] = split;       // right box
            if (overlap_intersects(c, u, bs.data(), be.data(), skip, axis,
                                   true))
                ro.push_back(u);
            bs[axis] = orig_s;
        } else ro.push_back(u);
    }

    BNode* n = new BNode();
    n->axis = axis;
    n->split = split;

    std::vector<float> lbe = be;
    lbe[axis] = split;
    std::vector<float> rbs = bs;
    rbs[axis] = split;

    if (pool.avail.fetch_sub(1) > 0) {
        // a worker slot is free: left subtree on its own thread, right
        // inline (tracer.hpp:2347-2351)
        std::exception_ptr err;
        std::thread th([&] {
            try {
                n->l = create_node(c, pool, depth, bs, std::move(lbe),
                                   std::move(lc), std::move(lo));
            } catch (...) {
                err = std::current_exception();
            }
        });
        try {
            n->r = create_node(c, pool, depth, std::move(rbs), be,
                               std::move(rc), std::move(ro));
        } catch (...) {
            th.join();
            pool.avail.fetch_add(1);
            delete n;
            throw;
        }
        th.join();
        pool.avail.fetch_add(1);
        if (err) {
            delete n;
            std::rethrow_exception(err);
        }
    } else {
        pool.avail.fetch_add(1);
        n->l = create_node(c, pool, depth, std::move(bs), std::move(lbe),
                           std::move(lc), std::move(lo));
        n->r = create_node(c, pool, depth, std::move(rbs), std::move(be),
                           std::move(rc), std::move(ro));
    }
    return n;
}

// deterministic pre-order flatten: identical output arrays regardless of
// how many threads built the tree
int32_t flatten_node(Output& o, const BNode* n) {
    if (!n) return -1;
    int32_t id = (int32_t)o.axis.size();
    if (n->axis < 0) {
        o.axis.push_back(-1);
        o.split.push_back(0);
        o.left.push_back(-1);
        o.right.push_back(-1);
        o.leaf_start.push_back((int32_t)o.items.size());
        o.leaf_count.push_back((int32_t)n->items.size());
        o.items.insert(o.items.end(), n->items.begin(), n->items.end());
        return id;
    }
    o.axis.push_back(n->axis);
    o.split.push_back(n->split);
    o.left.push_back(-1);
    o.right.push_back(-1);
    o.leaf_start.push_back(0);
    o.leaf_count.push_back(0);
    int32_t l = flatten_node(o, n->l);
    int32_t r = flatten_node(o, n->r);
    o.left[id] = l;
    o.right[id] = r;
    return id;
}

}  // namespace

extern "C" {

void* ntr_build(int n, int d, const float* b_start, const float* b_end,
                const int32_t* kind, const int32_t* tri_offset,
                const int32_t* tri_count, const float* pts,
                const float* axes, const float* fnormal,
                const float* sol_orient, const float* sol_inv,
                const float* sol_pos, int max_depth, int split_threshold,
                float traversal, float intersection, int extra_threads,
                int32_t* root_out) {
    Ctx* c = new Ctx();
    c->in = Input{n, d, b_start, b_end, kind, tri_offset, tri_count, pts,
                  axes, fnormal, sol_orient, sol_inv, sol_pos, max_depth,
                  split_threshold, traversal, intersection};

    // global boundary = union of unit AABBs (tracer.hpp:2434-2438)
    std::vector<float> bs(d, std::numeric_limits<float>::max());
    std::vector<float> be(d, std::numeric_limits<float>::lowest());
    for (int u = 0; u < n; ++u)
        for (int i = 0; i < d; ++i) {
            bs[i] = std::min(bs[i], b_start[(size_t)u * d + i]);
            be[i] = std::max(be[i], b_end[(size_t)u * d + i]);
        }

    std::vector<int32_t> contain(n);
    for (int u = 0; u < n; ++u) contain[u] = u;

    // extra_threads < 0 => hardware threads - 1 (ntracer_body.hpp:3258-3270)
    BuildPool pool;
    pool.avail.store(extra_threads < 0
        ? std::max(0, (int)std::thread::hardware_concurrency() - 1)
        : extra_threads);

    BNode* root = nullptr;
    try {
        root = create_node(*c, pool, -1, std::move(bs), std::move(be),
                           std::move(contain), {});
    } catch (...) {
        delete c;
        *root_out = -1;
        return nullptr;
    }
    *root_out = flatten_node(c->out, root);
    delete root;
    return c;
}

int32_t ntr_num_nodes(void* h) {
    return (int32_t)((Ctx*)h)->out.axis.size();
}

int32_t ntr_num_items(void* h) {
    return (int32_t)((Ctx*)h)->out.items.size();
}

void ntr_get_nodes(void* h, int32_t* axis, float* split, int32_t* left,
                   int32_t* right, int32_t* leaf_start, int32_t* leaf_count,
                   int32_t* items) {
    Output& o = ((Ctx*)h)->out;
    std::memcpy(axis, o.axis.data(), o.axis.size() * sizeof(int32_t));
    std::memcpy(split, o.split.data(), o.split.size() * sizeof(float));
    std::memcpy(left, o.left.data(), o.left.size() * sizeof(int32_t));
    std::memcpy(right, o.right.data(), o.right.size() * sizeof(int32_t));
    std::memcpy(leaf_start, o.leaf_start.data(),
                o.leaf_start.size() * sizeof(int32_t));
    std::memcpy(leaf_count, o.leaf_count.data(),
                o.leaf_count.size() * sizeof(int32_t));
    std::memcpy(items, o.items.data(), o.items.size() * sizeof(int32_t));
}


int32_t ntr_group_select(int n, int d, const float* starts,
                         const float* ends, const uint8_t* is_tri,
                         int window, int batch, int32_t* out_idx) {
    // Greedy windowed batch grouping: the selection loop of
    // kdtree.group_primitives, bit-for-bit (f32 leave-one-out surface
    // metric with sequential accumulation; stable (metric, index)
    // selection; linked-list scan over live candidates).  out_idx must
    // hold n int32; returns the group count G (groups are `batch`
    // consecutive indices, pivot first).
    if (d > 16) return -1;  // caller falls back to the Python loop
    std::vector<int32_t> nxt(n), prv(n);
    std::vector<char> consumed(n, 0);
    for (int i = 0; i < n; i++) { nxt[i] = i + 1; prv[i] = i - 1; }
    auto unlink = [&](int j) {
        consumed[j] = 1;
        int a = prv[j], b = nxt[j];
        if (a >= 0) nxt[a] = b;
        if (b < n) prv[b] = a;
    };
    std::vector<int32_t> idxs; idxs.reserve(window);
    std::vector<std::pair<float, int32_t>> cand; cand.reserve(window);
    int32_t ngroups = 0;
    for (int pi = 0; pi < n; pi++) {
        if (consumed[pi] || !is_tri[pi]) continue;
        idxs.clear();
        for (int pj = nxt[pi]; pj < n && (int)idxs.size() < window;
             pj = nxt[pj])
            if (is_tri[pj]) idxs.push_back(pj);
        if ((int)idxs.size() < batch - 1) break;
        const float* ps = starts + (size_t)pi * d;
        const float* pe = ends + (size_t)pi * d;
        cand.clear();
        for (int32_t j : idxs) {
            const float* qs = starts + (size_t)j * d;
            const float* qe = ends + (size_t)j * d;
            float comb[16], prefix[17], suffix[17];
            for (int k = 0; k < d; k++)
                comb[k] = std::max(pe[k], qe[k]) - std::min(ps[k], qs[k]);
            prefix[0] = 1.0f;
            suffix[d] = 1.0f;
            for (int k = 0; k < d; k++) prefix[k + 1] = prefix[k] * comb[k];
            for (int k = d - 1; k >= 0; k--) suffix[k] = suffix[k + 1] * comb[k];
            float m = 0.0f;
            for (int k = 0; k < d; k++) m = m + prefix[k] * suffix[k + 1];
            cand.emplace_back(m, j);
        }
        std::stable_sort(cand.begin(), cand.end(),
                         [](const std::pair<float, int32_t>& a,
                            const std::pair<float, int32_t>& b) {
                             return a.first < b.first;
                         });
        int32_t* g = out_idx + (size_t)ngroups * batch;
        g[0] = pi;
        unlink(pi);
        for (int k = 0; k < batch - 1; k++) {
            g[1 + k] = cand[k].second;
            unlink(cand[k].second);
        }
        ngroups++;
    }
    return ngroups;
}

void ntr_free(void* h) { delete (Ctx*)h; }

}  // extern "C"
