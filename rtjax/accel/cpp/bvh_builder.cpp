// Native full-sweep SAH BVH builder.
//
// C++ implementation of the reference's host-side builder
// (/root/reference/bvh.cuh:30-219) with identical algorithm and outputs to
// the NumPy fallback (rtjax/accel/builder_np.py):
//   - three axis-sorted index lists (bvh.cuh:72-87),
//   - explicit-stack top-down build (bvh.cuh:90-200),
//   - full-sweep SAH (suffix costs right-to-left, prefix scan
//     left-to-right, min over the three axes, bvh.cuh:124-141),
//   - leaf when count <= 1, depth cap, or best_cost >= half_area*(count-1)
//     (bvh.cuh:112,143-150), with the optional max_leaf_size forced split,
//   - stable partition of the other two axis lists (bvh.cuh:161-175),
//   - children adjacent (right = left + 1), smaller subtree first
//     (bvh.cuh:153-154,186-199).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).
// Build: g++ -O3 -march=native -shared -fPIC -o libbvh.so bvh_builder.cpp

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
    float x, y, z;
};

inline float half_area(const V3 &lo, const V3 &hi) {
    float e0 = hi.x - lo.x, e1 = hi.y - lo.y, e2 = hi.z - lo.z;
    return (e0 + e1) * e2 + e0 * e1;
}

inline void vmin(V3 &a, const V3 &b) {
    a.x = std::min(a.x, b.x);
    a.y = std::min(a.y, b.y);
    a.z = std::min(a.z, b.z);
}

inline void vmax(V3 &a, const V3 &b) {
    a.x = std::max(a.x, b.x);
    a.y = std::max(a.y, b.y);
    a.z = std::max(a.z, b.z);
}

inline float comp(const V3 &v, int axis) {
    return axis == 0 ? v.x : (axis == 1 ? v.y : v.z);
}

struct Task {
    int32_t node;
    int64_t begin, end;
    int32_t depth;
};

}  // namespace

extern "C" int64_t rtjax_build_bvh(
    const float *tri_bmin,   // [n, 3]
    const float *tri_bmax,   // [n, 3]
    const float *centers,    // [n, 3]
    int64_t n,
    int32_t max_depth,
    int32_t max_leaf_size,   // <= 0: reference behavior (no forced split)
    int32_t min_leaf_size,   // stop splitting at <= this many prims (ref: 1)
    float *out_bmin,         // [2n, 3]
    float *out_bmax,         // [2n, 3]
    int32_t *out_left_first, // [2n]
    int32_t *out_num_prims,  // [2n]
    int64_t *out_perm,       // [n]
    int32_t *out_stats       // [2]: num_nodes, max_depth_reached
) {
    if (n < 1) return -1;
    const V3 *bmin = reinterpret_cast<const V3 *>(tri_bmin);
    const V3 *bmax = reinterpret_cast<const V3 *>(tri_bmax);
    const V3 *ctr = reinterpret_cast<const V3 *>(centers);

    // three axis-sorted index lists (bvh.cuh:72-87)
    std::vector<int64_t> refs[3];
    for (int a = 0; a < 3; a++) {
        refs[a].resize(n);
        for (int64_t i = 0; i < n; i++) refs[a][i] = i;
    }
    // stable sorts: the reference uses std::sort (unstable on centroid
    // ties, bvh.cuh:75); stable ordering makes builds reproducible and
    // bit-identical with the NumPy fallback (kind="stable")
    std::stable_sort(refs[0].begin(), refs[0].end(),
                     [&](int64_t i, int64_t j) { return ctr[i].x < ctr[j].x; });
    std::stable_sort(refs[1].begin(), refs[1].end(),
                     [&](int64_t i, int64_t j) { return ctr[i].y < ctr[j].y; });
    std::stable_sort(refs[2].begin(), refs[2].end(),
                     [&](int64_t i, int64_t j) { return ctr[i].z < ctr[j].z; });

    std::vector<float> costs(n);
    std::vector<uint8_t> marks(n);
    std::vector<int64_t> tmp(n);

    V3 *node_bmin = reinterpret_cast<V3 *>(out_bmin);
    V3 *node_bmax = reinterpret_cast<V3 *>(out_bmax);

    // root bbox (bvh.cuh:54-61)
    node_bmin[0] = bmin[0];
    node_bmax[0] = bmax[0];
    for (int64_t i = 1; i < n; i++) {
        vmin(node_bmin[0], bmin[i]);
        vmax(node_bmax[0], bmax[i]);
    }

    int32_t num_nodes = 1;
    int32_t out_max_depth = 0;

    std::vector<Task> stack;
    int32_t node = 0, depth = 0;
    int64_t begin = 0, end = n;

    while (true) {
        const int64_t count = end - begin;
        const bool at_cap = depth >= max_depth;
        // at the depth cap an oversized range must still be split (median):
        // bounded leaves are a hard kernel requirement (builder_np.py has
        // the identical rule — keep the two builders bit-identical)
        bool make_leaf = (count <= min_leaf_size) ||
            (at_cap && (max_leaf_size <= 0 || count <= max_leaf_size));
        int best_axis = -1;
        int64_t best_split = -1;

        if (!make_leaf && at_cap) {
            float best_ext = -FLT_MAX;
            for (int a = 0; a < 3; a++) {
                float ext = comp(ctr[refs[a][end - 1]], a)
                            - comp(ctr[refs[a][begin]], a);
                if (ext > best_ext) {
                    best_ext = ext;
                    best_axis = a;
                }
            }
            best_split = begin + count / 2;
        } else if (!make_leaf) {
            float best_cost = FLT_MAX;
            for (int axis = 0; axis < 3; axis++) {
                const int64_t *idx = refs[axis].data() + begin;
                // suffix: bbox of [i, end) (bvh.cuh:125-129)
                V3 lo = bmin[idx[count - 1]], hi = bmax[idx[count - 1]];
                costs[count - 1] = half_area(lo, hi);
                for (int64_t i = count - 1; i > 0; i--) {
                    vmin(lo, bmin[idx[i]]);
                    vmax(hi, bmax[idx[i]]);
                    costs[i] = half_area(lo, hi) * (float)(count - i);
                }
                // prefix scan picking min cost (bvh.cuh:131-140)
                lo = bmin[idx[0]];
                hi = bmax[idx[0]];
                for (int64_t i = 0; i < count - 1; i++) {
                    vmin(lo, bmin[idx[i]]);
                    vmax(hi, bmax[idx[i]]);
                    float cost = half_area(lo, hi) * (float)(i + 1)
                                 + costs[i + 1];
                    if (cost < best_cost) {
                        best_cost = cost;
                        best_axis = axis;
                        best_split = begin + i + 1;
                    }
                }
            }

            const float max_split_cost =
                half_area(node_bmin[node], node_bmax[node]) * (float)(count - 1);
            if (best_cost >= max_split_cost) {
                if (max_leaf_size <= 0 || count <= max_leaf_size)
                    make_leaf = true;
                // else: forced split at best_split (leaf-size bound)
            }
        }

        if (make_leaf) {
            out_num_prims[node] = (int32_t)count;
            out_left_first[node] = (int32_t)begin;
            if (stack.empty()) break;
            Task t = stack.back();
            stack.pop_back();
            node = t.node;
            begin = t.begin;
            end = t.end;
            depth = t.depth;
            continue;
        }

        // child bboxes + marks over the best-axis order (bvh.cuh:152-166)
        const int32_t lnode = num_nodes, rnode = num_nodes + 1;
        {
            V3 lo = bmin[refs[best_axis][begin]];
            V3 hi = bmax[refs[best_axis][begin]];
            for (int64_t i = begin; i < best_split; i++) {
                const int64_t r = refs[best_axis][i];
                vmin(lo, bmin[r]);
                vmax(hi, bmax[r]);
                marks[r] = 1;
            }
            node_bmin[lnode] = lo;
            node_bmax[lnode] = hi;
        }
        {
            V3 lo = bmin[refs[best_axis][best_split]];
            V3 hi = bmax[refs[best_axis][best_split]];
            for (int64_t i = best_split; i < end; i++) {
                const int64_t r = refs[best_axis][i];
                vmin(lo, bmin[r]);
                vmax(hi, bmax[r]);
                marks[r] = 0;
            }
            node_bmin[rnode] = lo;
            node_bmax[rnode] = hi;
        }

        // stable partition of the other two axis lists (bvh.cuh:168-175)
        for (int k = 1; k <= 2; k++) {
            int64_t *seg = refs[(best_axis + k) % 3].data();
            int64_t a = begin, b = 0;
            for (int64_t i = begin; i < end; i++) {
                if (marks[seg[i]]) seg[a++] = seg[i];
                else tmp[b++] = seg[i];
            }
            std::memcpy(seg + a, tmp.data(), b * sizeof(int64_t));
        }

        num_nodes += 2;
        out_num_prims[node] = 0;
        out_left_first[node] = lnode;
        out_max_depth = std::max(out_max_depth, depth + 1);

        const int64_t left_size = best_split - begin;
        const int64_t right_size = end - best_split;
        if (left_size < right_size) {  // smaller subtree first (bvh.cuh:186)
            stack.push_back({rnode, best_split, end, depth + 1});
            node = lnode;
            end = best_split;
            depth = depth + 1;
        } else {
            stack.push_back({lnode, begin, best_split, depth + 1});
            node = rnode;
            begin = best_split;
            depth = depth + 1;
        }
    }

    // primitives permuted by the x-axis list (bvh.cuh:208)
    std::memcpy(out_perm, refs[0].data(), n * sizeof(int64_t));
    out_stats[0] = num_nodes;
    out_stats[1] = out_max_depth;
    return num_nodes;
}
