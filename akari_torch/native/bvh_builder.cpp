// Native binned-SAH BVH builder producing the threaded (skip-link) layout
// consumed by akari_torch/bvh (see build.py for the layout contract).
// A copy of akari_tpu/native/bvh_builder.cpp; only this header comment
// differs. The same code built with the same flags gives the reference's
// triangle storage order, and with it the same prim ids.
//
// Capability parity with the reference's C++ builder
// (ref: src/akari/kernel/bvh-accelerator.h:151-223 binned SAH object splits;
// the std::async parallel recursion at :459-467 maps to the task pool here).
// The Python/NumPy builder (bvh/build.py) is the semantic oracle; this
// builder exists for large scenes where Python-loop build time dominates.
//
// C ABI (ctypes):
//   int akr_bvh_build(const float* p0, const float* p1, const float* p2,
//                     int64_t n_tris, int max_leaf,
//                     float* node_lo, float* node_hi, int32_t* first,
//                     int32_t* count, int32_t* miss, int32_t* order,
//                     int64_t max_nodes, int64_t* out_n_nodes);
// Returns 0 on success, nonzero on error (1 = node buffer too small).
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17
// ... -lpthread, the reference loader's flags; no -march=native).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <future>
#include <limits>
#include <mutex>
#include <vector>

namespace {

constexpr int kNumBins = 16;

struct Vec3 {
    float x, y, z;
    float operator[](int i) const { return (&x)[i]; }
    float& operator[](int i) { return (&x)[i]; }
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
    Vec3 lo{+INFINITY, +INFINITY, +INFINITY};
    Vec3 hi{-INFINITY, -INFINITY, -INFINITY};
    void extend(const Box& b) {
        lo = vmin(lo, b.lo);
        hi = vmax(hi, b.hi);
    }
    float area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return 2.f * (dx * dy + dy * dz + dz * dx);
    }
};

struct BuildNode {
    Box box;
    int64_t start = 0, end = 0;   // range into order[] (leaf only)
    BuildNode* left = nullptr;
    BuildNode* right = nullptr;
    int64_t subtree_size = 1;
};

struct Builder {
    const Box* boxes;
    const Vec3* centroids;
    int64_t* order;
    int max_leaf;
    std::atomic<int64_t> node_count{0};
    // Node storage: chunked arena so pointers stay stable across threads.
    std::vector<std::vector<BuildNode>*> arenas;
    std::mutex arena_mu;

    ~Builder() {
        for (auto* a : arenas) delete a;
    }

    BuildNode* new_node(std::vector<BuildNode>& arena) {
        node_count.fetch_add(1, std::memory_order_relaxed);
        arena.emplace_back();
        return &arena.back();
    }

    BuildNode* build(std::vector<BuildNode>& arena, int64_t start, int64_t end,
                     int depth) {
        // Arena must have capacity for this subtree (reserved by caller).
        BuildNode* node = new_node(arena);
        Box bounds;
        Box cbounds;
        for (int64_t i = start; i < end; ++i) {
            bounds.extend(boxes[order[i]]);
            const Vec3& c = centroids[order[i]];
            cbounds.lo = vmin(cbounds.lo, c);
            cbounds.hi = vmax(cbounds.hi, c);
        }
        node->box = bounds;
        node->start = start;
        node->end = end;
        int64_t n = end - start;
        if (n <= 2) return node;

        Vec3 extent{cbounds.hi.x - cbounds.lo.x, cbounds.hi.y - cbounds.lo.y,
                    cbounds.hi.z - cbounds.lo.z};
        int axis = 0;
        if (extent.y > extent.x) axis = 1;
        if (extent.z > extent[axis]) axis = 2;

        int64_t split = -1;
        if (extent[axis] > 1e-12f) {
            // Binned SAH.
            int64_t bin_count[kNumBins] = {0};
            Box bin_box[kNumBins];
            float inv = kNumBins / extent[axis];
            auto bin_of = [&](int64_t i) {
                int b = (int)((centroids[order[i]][axis] - cbounds.lo[axis]) * inv);
                return std::min(b, kNumBins - 1);
            };
            for (int64_t i = start; i < end; ++i) {
                int b = bin_of(i);
                bin_count[b]++;
                bin_box[b].extend(boxes[order[i]]);
            }
            // suffix sweep
            float right_area[kNumBins];
            Box acc;
            int64_t right_n[kNumBins];
            int64_t rn = 0;
            for (int k = kNumBins - 1; k >= 1; --k) {
                acc.extend(bin_box[k]);
                rn += bin_count[k];
                right_area[k] = acc.area();
                right_n[k] = rn;
            }
            // prefix sweep + cost
            Box lacc;
            int64_t ln = 0;
            float best_cost = INFINITY;
            int best_k = -1;
            for (int k = 0; k < kNumBins - 1; ++k) {
                lacc.extend(bin_box[k]);
                ln += bin_count[k];
                if (ln == 0 || right_n[k + 1] == 0) continue;
                float cost = ln * lacc.area() + right_n[k + 1] * right_area[k + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    best_k = k;
                }
            }
            if (best_k >= 0) {
                float leaf_cost = (float)n * bounds.area();
                float split_cost = bounds.area() + best_cost;
                if (n <= max_leaf && split_cost >= leaf_cost) return node;
                int64_t* mid = std::partition(
                    order + start, order + end, [&](int64_t t) {
                        int b = (int)((centroids[t][axis] - cbounds.lo[axis]) * inv);
                        return std::min(b, kNumBins - 1) <= best_k;
                    });
                split = mid - order;
            }
        }
        if (split <= start || split >= end) {
            // median fallback (degenerate centroids / failed SAH)
            int64_t mid = start + n / 2;
            std::nth_element(order + start, order + mid, order + end,
                             [&](int64_t a, int64_t b) {
                                 return centroids[a][axis] < centroids[b][axis];
                             });
            split = mid;
        }

        if (n > 128 * 1024 && depth < 12) {
            // Parallel children (ref: std::async recursion, :459-467).
            auto* right_arena = new std::vector<BuildNode>();
            right_arena->reserve(2 * (end - split));
            {
                std::lock_guard<std::mutex> g(arena_mu);
                arenas.push_back(right_arena);
            }
            auto fut = std::async(std::launch::async, [&, split, end, depth]() {
                return build(*right_arena, split, end, depth + 1);
            });
            node->left = build(arena, start, split, depth + 1);
            node->right = fut.get();
        } else {
            node->left = build(arena, start, split, depth + 1);
            node->right = build(arena, split, end, depth + 1);
        }
        node->subtree_size =
            1 + node->left->subtree_size + node->right->subtree_size;
        return node;
    }

    void split_fat_leaves(std::vector<BuildNode>& arena, BuildNode* node) {
        if (node->left) {
            split_fat_leaves(arena, node->left);
            split_fat_leaves(arena, node->right);
            node->subtree_size =
                1 + node->left->subtree_size + node->right->subtree_size;
            return;
        }
        int64_t n = node->end - node->start;
        if (n <= max_leaf) return;
        // median split on widest centroid axis
        Box cb;
        for (int64_t i = node->start; i < node->end; ++i) {
            const Vec3& c = centroids[order[i]];
            cb.lo = vmin(cb.lo, c);
            cb.hi = vmax(cb.hi, c);
        }
        Vec3 ext{cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
        int axis = 0;
        if (ext.y > ext.x) axis = 1;
        if (ext.z > ext[axis]) axis = 2;
        int64_t mid = node->start + n / 2;
        std::nth_element(order + node->start, order + mid, order + node->end,
                         [&](int64_t a, int64_t b) {
                             return centroids[a][axis] < centroids[b][axis];
                         });
        auto make = [&](int64_t s, int64_t e) {
            BuildNode* c = new_node(arena);
            Box b;
            for (int64_t i = s; i < e; ++i) b.extend(boxes[order[i]]);
            c->box = b;
            c->start = s;
            c->end = e;
            return c;
        };
        node->left = make(node->start, mid);
        node->right = make(mid, node->end);
        split_fat_leaves(arena, node->left);
        split_fat_leaves(arena, node->right);
        node->subtree_size =
            1 + node->left->subtree_size + node->right->subtree_size;
    }
};

// Iterative preorder flatten with skip links (mirrors build.py _flatten).
int64_t flatten(BuildNode* root, float* node_lo, float* node_hi, int32_t* first,
                int32_t* count, int32_t* miss, int64_t max_nodes) {
    std::vector<std::pair<BuildNode*, int32_t>> stack;
    stack.push_back({root, -1});
    int64_t idx = 0;
    while (!stack.empty()) {
        auto [node, miss_link] = stack.back();
        stack.pop_back();
        if (idx >= max_nodes) return -1;
        // slightly padded bounds for watertight f32 traversal
        for (int k = 0; k < 3; ++k) {
            float lo = node->box.lo[k], hi = node->box.hi[k];
            float eps = 1e-6f * std::max(1.f, std::fabs(lo) + std::fabs(hi));
            node_lo[3 * idx + k] = lo - eps;
            node_hi[3 * idx + k] = hi + eps;
        }
        bool leaf = node->left == nullptr;
        first[idx] = leaf ? (int32_t)node->start : 0;
        count[idx] = leaf ? (int32_t)(node->end - node->start) : 0;
        miss[idx] = miss_link;
        if (!leaf) {
            int32_t right_idx = (int32_t)(idx + 1 + node->left->subtree_size);
            stack.push_back({node->right, miss_link});
            stack.push_back({node->left, right_idx});
        }
        ++idx;
    }
    return idx;
}

}  // namespace

extern "C" int akr_bvh_build(const float* p0, const float* p1, const float* p2,
                             int64_t n_tris, int max_leaf, float* node_lo,
                             float* node_hi, int32_t* first, int32_t* count,
                             int32_t* miss, int32_t* order_out,
                             int64_t max_nodes, int64_t* out_n_nodes) {
    if (n_tris <= 0) return 2;
    std::vector<Box> boxes(n_tris);
    std::vector<Vec3> centroids(n_tris);
    for (int64_t i = 0; i < n_tris; ++i) {
        Vec3 a{p0[3 * i], p0[3 * i + 1], p0[3 * i + 2]};
        Vec3 b{p1[3 * i], p1[3 * i + 1], p1[3 * i + 2]};
        Vec3 c{p2[3 * i], p2[3 * i + 1], p2[3 * i + 2]};
        boxes[i].lo = vmin(vmin(a, b), c);
        boxes[i].hi = vmax(vmax(a, b), c);
        centroids[i] = {(boxes[i].lo.x + boxes[i].hi.x) * 0.5f,
                        (boxes[i].lo.y + boxes[i].hi.y) * 0.5f,
                        (boxes[i].lo.z + boxes[i].hi.z) * 0.5f};
    }
    std::vector<int64_t> order(n_tris);
    for (int64_t i = 0; i < n_tris; ++i) order[i] = i;

    Builder builder;
    builder.boxes = boxes.data();
    builder.centroids = centroids.data();
    builder.order = order.data();
    builder.max_leaf = max_leaf;

    auto* root_arena = new std::vector<BuildNode>();
    root_arena->reserve(4 * n_tris + 64);
    {
        std::lock_guard<std::mutex> g(builder.arena_mu);
        builder.arenas.push_back(root_arena);
    }
    BuildNode* root = builder.build(*root_arena, 0, n_tris, 0);
    builder.split_fat_leaves(*root_arena, root);

    int64_t n_nodes =
        flatten(root, node_lo, node_hi, first, count, miss, max_nodes);
    if (n_nodes < 0) return 1;
    *out_n_nodes = n_nodes;
    for (int64_t i = 0; i < n_tris; ++i) order_out[i] = (int32_t)order[i];
    return 0;
}
