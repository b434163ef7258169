// One-thread-per-ray BVH walks: closest hit and any hit.
//
// The walk of the CUDA reference (bvh.cuh:251-357, device_stack.cuh), kept
// rule for rule equal to the XLA walk in rtjax/kernels/traversal.py:
//   - ordered descent: nearer child first, farther pushed (entry compare);
//   - leaves intersected inline, shrinking tmax;
//   - the slab test does NOT clip against [0, tmax];
//   - any hit skips one excluded triangle by index and exits on the first
//     hit.
// The same code compiles as CUDA device code (walk_cuda.cu) and as host C++
// (walk_host.cc), so the CPU tests check the arithmetic the GPU runs.
//
// Records (packed at scene build by rtjax/kernels/native_walk.py):
//   node  i: two int4  (bmin.xyz as float bits, left_first)
//                      (bmax.xyz as float bits, num_prims)
//   tri   i: three float4 (p0.xyz, n.x) (e1.xyz, n.y) (e2.xyz, n.z)
// Node 0 is always internal (BuildResult.padded_arrays pads leaf roots).
#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#ifdef __CUDACC__
#define RTJAX_HD __host__ __device__ __forceinline__
#else
#define RTJAX_HD inline
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
#endif

namespace rtjax {

RTJAX_HD int4 load(const int4 *p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

RTJAX_HD float4 load(const float4 *p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

RTJAX_HD float bits_to_float(int i) {
#ifdef __CUDA_ARCH__
    return __int_as_float(i);
#else
    float f;
    std::memcpy(&f, &i, sizeof f);
    return f;
#endif
}

[[noreturn]] RTJAX_HD void stack_overflow() {
#ifdef __CUDA_ARCH__
    __trap();
#else
    std::abort();
#endif
}

// NaN-propagating min/max, as jnp.max/jnp.min over the three slabs.
RTJAX_HD float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }
RTJAX_HD float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }

struct Ray {
    float ox, oy, oz, dx, dy, dz;
};

// Per-ray slab state (aabb_intersector.cuh:14-22; core.geometry
// ray_slab_precompute): near-zero direction components are nudged to
// +-FLT_EPSILON before the reciprocal.
struct Slab {
    float ix, iy, iz, sx, sy, sz;
    bool nx, ny, nz;
};

RTJAX_HD float safe_inv(float d) {
    float s = fabsf(d) < FLT_EPSILON ? copysignf(FLT_EPSILON, d) : d;
    return 1.0f / s;
}

RTJAX_HD Slab make_slab(const Ray &r) {
    Slab s;
    s.ix = safe_inv(r.dx);
    s.iy = safe_inv(r.dy);
    s.iz = safe_inv(r.dz);
    s.sx = -r.ox * s.ix;
    s.sy = -r.oy * s.iy;
    s.sz = -r.oz * s.iz;
    s.nx = r.dx < 0.0f;
    s.ny = r.dy < 0.0f;
    s.nz = r.dz < 0.0f;
    return s;
}

struct Node {
    float lo[3], hi[3];
    int first, num;
};

RTJAX_HD Node load_node(const int4 *nodes, int i) {
    int4 a = load(nodes + 2 * i);
    int4 b = load(nodes + 2 * i + 1);
    Node n;
    n.lo[0] = bits_to_float(a.x);
    n.lo[1] = bits_to_float(a.y);
    n.lo[2] = bits_to_float(a.z);
    n.first = a.w;
    n.hi[0] = bits_to_float(b.x);
    n.hi[1] = bits_to_float(b.y);
    n.hi[2] = bits_to_float(b.z);
    n.num = b.w;
    return n;
}

// Slab test of the infinite ray (no [0, tmax] clip); returns the overlap
// and writes the entry distance.
RTJAX_HD bool slab_test(const Slab &s, const Node &n, float &entry) {
    float nx = s.nx ? n.hi[0] : n.lo[0], fx = s.nx ? n.lo[0] : n.hi[0];
    float ny = s.ny ? n.hi[1] : n.lo[1], fy = s.ny ? n.lo[1] : n.hi[1];
    float nz = s.nz ? n.hi[2] : n.lo[2], fz = s.nz ? n.lo[2] : n.hi[2];
    float e = nan_max(nan_max(s.ix * nx + s.sx, s.iy * ny + s.sy),
                      s.iz * nz + s.sz);
    float x = nan_min(nan_min(s.ix * fx + s.sx, s.iy * fy + s.sy),
                      s.iz * fz + s.sz);
    entry = e;
    return e <= x;
}

struct Tri {
    float p0[3], e1[3], e2[3], n[3];
};

RTJAX_HD Tri load_tri(const float4 *tris, int i) {
    float4 a = load(tris + 3 * i);
    float4 b = load(tris + 3 * i + 1);
    float4 c = load(tris + 3 * i + 2);
    Tri t = {{a.x, a.y, a.z}, {b.x, b.y, b.z}, {c.x, c.y, c.z},
             {a.w, b.w, c.w}};
    return t;
}

// Moeller-Trumbore variant of triangle.cuh:39-58 with the reference's
// accept rule u >= 0, v >= 0, u + v <= 1, 0 < t <= tmax (the same operation
// order as core.geometry.intersect_triangle_v3).
RTJAX_HD bool intersect(const Ray &r, const Tri &tr, float tmax, float &t) {
    float cx = tr.p0[0] - r.ox, cy = tr.p0[1] - r.oy, cz = tr.p0[2] - r.oz;
    float rx = r.dy * cz - r.dz * cy;
    float ry = r.dz * cx - r.dx * cz;
    float rz = r.dx * cy - r.dy * cx;
    float inv_det = 1.0f / (r.dx * tr.n[0] + r.dy * tr.n[1] + r.dz * tr.n[2]);
    float u = inv_det * (tr.e2[0] * rx + tr.e2[1] * ry + tr.e2[2] * rz);
    float v = inv_det * (tr.e1[0] * rx + tr.e1[1] * ry + tr.e1[2] * rz);
    t = inv_det * (cx * tr.n[0] + cy * tr.n[1] + cz * tr.n[2]);
    return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && t <= tmax;
}

struct Hit {
    bool hit;
    float t;
    int prim;
    float n[3];
    int steps, leafs;
};

RTJAX_HD void leaf_closest(const float4 *tris, const Ray &r, const Node &leaf,
                           float &tmax, Hit &h) {
    for (int i = 0; i < leaf.num; ++i) {
        int ti = leaf.first + i;
        Tri tr = load_tri(tris, ti);
        float t;
        if (intersect(r, tr, tmax, t)) {
            tmax = t;
            h.hit = true;
            h.t = t;
            h.prim = ti;
            h.n[0] = tr.n[0];
            h.n[1] = tr.n[1];
            h.n[2] = tr.n[2];
        }
    }
}

RTJAX_HD bool leaf_any(const float4 *tris, const Ray &r, const Node &leaf,
                       float tmax, int exclude) {
    for (int i = 0; i < leaf.num; ++i) {
        int ti = leaf.first + i;
        float t;
        if (intersect(r, load_tri(tris, ti), tmax, t) && ti != exclude)
            return true;
    }
    return false;
}

// Descent shared by both walks (bvh.cuh:282-299): both children live ->
// visit the nearer, push the farther; one live -> visit it; none -> pop.
// Returns false when the stack is empty (walk done).
template <int STACK>
RTJAX_HD bool next_node(const Node &l, const Node &r, bool live_l, bool live_r,
                        float entry_l, float entry_r, int *stack, int &sp,
                        int &cur) {
    if (live_l && live_r) {
        bool l_far = entry_l > entry_r;
        if (sp >= STACK) stack_overflow();
        stack[sp++] = l_far ? l.first : r.first;
        cur = l_far ? r.first : l.first;
    } else if (live_l) {
        cur = l.first;
    } else if (live_r) {
        cur = r.first;
    } else {
        if (sp == 0) return false;
        cur = stack[--sp];
    }
    return true;
}

template <int STACK>
RTJAX_HD Hit walk_closest(const int4 *nodes, const float4 *tris, const Ray &r,
                          float tmax) {
    Hit h = {false, INFINITY, -1, {0.0f, 0.0f, 0.0f}, 0, 0};
    Slab s = make_slab(r);
    int stack[STACK];
    int sp = 0;
    int cur = load(nodes).w;  // root's left child
    do {
        h.steps += 1;
        Node l = load_node(nodes, cur);
        Node rn = load_node(nodes, cur + 1);
        float el, er;
        bool ok_l = slab_test(s, l, el), ok_r = slab_test(s, rn, er);
        bool leaf_l = l.num > 0, leaf_r = rn.num > 0;
        h.leafs += (ok_l && leaf_l) + (ok_r && leaf_r);
        if (ok_l && leaf_l) leaf_closest(tris, r, l, tmax, h);
        if (ok_r && leaf_r) leaf_closest(tris, r, rn, tmax, h);
        if (!next_node<STACK>(l, rn, ok_l && !leaf_l, ok_r && !leaf_r, el,
                              er, stack, sp, cur))
            break;
    } while (true);
    return h;
}

template <int STACK>
RTJAX_HD bool walk_anyhit(const int4 *nodes, const float4 *tris, const Ray &r,
                          float tmax, int exclude, int &steps, int &leafs) {
    Slab s = make_slab(r);
    int stack[STACK];
    int sp = 0;
    int cur = load(nodes).w;
    do {
        steps += 1;
        Node l = load_node(nodes, cur);
        Node rn = load_node(nodes, cur + 1);
        float el, er;
        bool ok_l = slab_test(s, l, el), ok_r = slab_test(s, rn, er);
        bool leaf_l = l.num > 0, leaf_r = rn.num > 0;
        leafs += (ok_l && leaf_l) + (ok_r && leaf_r);
        if (ok_l && leaf_l && leaf_any(tris, r, l, tmax, exclude)) return true;
        if (ok_r && leaf_r && leaf_any(tris, r, rn, tmax, exclude))
            return true;
        if (!next_node<STACK>(l, rn, ok_l && !leaf_l, ok_r && !leaf_r, el,
                              er, stack, sp, cur))
            break;
    } while (true);
    return false;
}

// Buffers of one closest-hit call.  Rays are component arrays of length n;
// steps/leafs are null unless per-ray walk counters were asked for.
struct ClosestArgs {
    const int4 *nodes;
    const float4 *tris;
    const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
    const bool *active;
    bool *hit;
    float *t;
    int *prim;
    float *nx, *ny, *nz;
    int *steps, *leafs;
};

struct AnyhitArgs {
    const int4 *nodes;
    const float4 *tris;
    const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
    const int *exclude;
    const bool *active;
    bool *occluded;
    int *steps, *leafs;
};

// One ray of a call.  Inactive lanes leave at once with a miss.
template <int STACK>
RTJAX_HD void closest_ray(const ClosestArgs &a, int64_t i) {
    Hit h = {false, INFINITY, -1, {0.0f, 0.0f, 0.0f}, 0, 0};
    if (a.active[i]) {
        Ray r = {a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i], a.dz[i]};
        h = walk_closest<STACK>(a.nodes, a.tris, r, a.tmax[i]);
    }
    a.hit[i] = h.hit;
    a.t[i] = h.t;
    a.prim[i] = h.prim;
    a.nx[i] = h.n[0];
    a.ny[i] = h.n[1];
    a.nz[i] = h.n[2];
    if (a.steps) {
        a.steps[i] = h.steps;
        a.leafs[i] = h.leafs;
    }
}

template <int STACK>
RTJAX_HD void anyhit_ray(const AnyhitArgs &a, int64_t i) {
    int steps = 0, leafs = 0;
    bool occ = false;
    if (a.active[i]) {
        Ray r = {a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i], a.dz[i]};
        occ = walk_anyhit<STACK>(a.nodes, a.tris, r, a.tmax[i], a.exclude[i],
                                 steps, leafs);
    }
    a.occluded[i] = occ;
    if (a.steps) {
        a.steps[i] = steps;
        a.leafs[i] = leafs;
    }
}

// Stack capacities the libraries are built for; the Python side picks the
// smallest that holds the build's depth and refuses deeper trees.
#define RTJAX_FOR_EACH_STACK(X) X(32) X(64) X(128) X(256)

}  // namespace rtjax
