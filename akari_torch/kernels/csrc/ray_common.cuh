// Pieces shared by the port's traversal kernels (tree_intersect.cu,
// instanced_tree_intersect.cu, cluster_intersect.cu): the reference's slab
// test and Moller-Trumbore test in its operation order, the closest-hit
// record with the lowest-index tie rule, the warp-cooperative leaf tests of
// all three (warp_leaves) and the tree walk of the two tree kernels
// (warp_walk). One thread owns one ray.
//
// Built with --fmad=false and IEEE division (kernels/build.py), so every
// float operation is rounded as the plain PyTorch versions round it.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace akr {

constexpr int BLOCK = 128;         // threads (rays) per block
constexpr int STACK_DEPTH = 64;    // refs per ray (cluster_tree.STACK_DEPTH)
constexpr int TRI_TILE = 128;      // triangles per cluster
constexpr int SUPER = 32;          // clusters per supercluster
constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float HIT_EPS = 1e-9f;
constexpr float T_MAX = 1e30f;
constexpr float DIR_EPS = 1e-12f;

__device__ __forceinline__ float safe_inv(float c) {
  const float s = fabsf(c) < DIR_EPS ? (c < 0.f ? -DIR_EPS : DIR_EPS) : c;
  return 1.0f / s;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin;
  float ix, iy, iz;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx,
                                        float dy, float dz, float tmin) {
  Ray r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.tmin = tmin;
  r.ix = safe_inv(dx);
  r.iy = safe_inv(dy);
  r.iz = safe_inv(dz);
  return r;
}

// Ray i of an [8, n] pack (ox oy oz dx dy dz tmin tmax); tmax to *tmax.
__device__ __forceinline__ Ray load_ray(const float* rays, long long n,
                                        long long i, float* tmax) {
  *tmax = rays[7 * n + i];
  return make_ray(rays[i], rays[n + i], rays[2 * n + i], rays[3 * n + i],
                  rays[4 * n + i], rays[5 * n + i], rays[6 * n + i]);
}

// pallas_tree.py slab_mask, per ray. A ray with a NaN component never hits
// a triangle, so fmaxf/fminf, which drop NaNs where the reference keeps
// them, change which boxes such a ray enters but never an output.
__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly,
                                     float lz, float hx, float hy, float hz,
                                     float best_t) {
  const float t0x = (lx - r.ox) * r.ix;
  const float t1x = (hx - r.ox) * r.ix;
  const float t0y = (ly - r.oy) * r.iy;
  const float t1y = (hy - r.oy) * r.iy;
  const float t0z = (lz - r.oz) * r.iz;
  const float t1z = (hz - r.oz) * r.iz;
  const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), r.tmin));
  const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fminf(fmaxf(t0z, t1z), best_t));
  return (near <= far) && (best_t > r.tmin);
}

// Slab test against an 8-float box row (lo.xyz, hi.xyz, pad, pad).
__device__ __forceinline__ bool slab_row(const Ray& r, const float4* row,
                                         float best_t) {
  const float4 a = __ldg(row), b = __ldg(row + 1);
  return slab(r, a.x, a.y, a.z, a.w, b.x, b.y, best_t);
}

// Running answer of one ray. Closest: best_t starts at min(t_max, T_MAX)
// (NaN stays NaN and never hits); a hit is taken when
// t < best_t || (t == best_t && prim < best_prim), so the answer is the
// lowest prim among the exact minima whatever order boxes are visited in.
// Any hit: best_t is t_max and the first hit ends the query.
struct Best {
  float t, u, v;
  int prim;
  bool occluded;
};

template <bool ANY_HIT>
__device__ __forceinline__ Best init_best(float tmax) {
  Best b;
  b.t = ANY_HIT ? tmax : (tmax > T_MAX ? T_MAX : tmax);
  b.u = 0.f;
  b.v = 0.f;
  b.prim = -1;
  b.occluded = false;
  return b;
}

// Moller-Trumbore of ray (o, d, tmin) against triangle (v0, e1, e2) in the
// operation order of `_pairwise_mt_t` (pallas_intersect.py:56-90): t, u, v
// and whether it hits in (tmin, inf), without the comparison against a
// best t.
__device__ __forceinline__ bool mt_test(float ox, float oy, float oz, float dx,
                                        float dy, float dz, float tmin,
                                        float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        float& t, float& u, float& v) {
  // pvec = d x e2
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv_det = 1.0f / (fabsf(det) < HIT_EPS ? 1.0f : det);
  const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  // qvec = tvec x e1
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return (fabsf(det) >= HIT_EPS) && (u >= 0.f) && (v >= 0.f) &&
         (u + v <= 1.f) && (t > tmin);
}

template <bool ANY_HIT>
__device__ __forceinline__ void store_best(const Best& b, long long i,
                                           float* t_out, float* u_out,
                                           float* v_out, int* prim_out,
                                           unsigned char* occ_out) {
  if (ANY_HIT) {
    occ_out[i] = b.occluded ? 1 : 0;
  } else {
    const bool valid = b.prim >= 0;
    t_out[i] = valid ? b.t : T_MAX;
    u_out[i] = b.u;
    v_out[i] = b.v;
    prim_out[i] = b.prim;
  }
}

// Where a warp-cooperative kernel finds a leaf's triangles: the
// component-major store `blocks` ([9, stride] floats: rows v0.xyz e1.xyz
// e2.xyz, a triangle per column) and, for the mesh being walked or swept,
// its cluster count, its real triangle count (a flat scene's last cluster
// is cut there), the column of its first cluster over TRI_TILE, and the
// prim id of its first triangle. Cluster c is columns TRI_TILE (tile_base + c) onward, and its
// triangle j is prim prim_base + TRI_TILE c + j.
struct LeafStore {
  const float* blocks;
  long long stride;
  int n_clusters, n_real, tile_base, prim_base;
};

// Push the hit children of inner node `ref` (the reference's slab test
// with the live best t), far first so the near one pops first; near and
// far by THIS ray's direction sign on the node's split axis.
__device__ __forceinline__ void push_children(const Ray& r, bool neg_x,
                                              bool neg_y, bool neg_z,
                                              const float4* __restrict__ nodes,
                                              int ref, float best_t,
                                              int* stack, int& sp) {
  const float4* row = nodes + 4 * (long long)ref;
  const float4 a = __ldg(row), b = __ldg(row + 1);
  const float4 c = __ldg(row + 2), e = __ldg(row + 3);
  const bool h0 = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, best_t);
  const bool h1 = slab(r, b.z, b.w, c.x, c.y, c.z, c.w, best_t);
  const int c0 = (int)e.x, c1 = (int)e.y, ax = (int)e.z;
  const bool neg = ax == 0 ? neg_x : (ax == 1 ? neg_y : neg_z);
  if (neg ? h0 : h1) stack[sp++] = neg ? c0 : c1;
  if (neg ? h1 : h0) stack[sp++] = neg ? c1 : c0;
}

// The leaf tests of the warp-cooperative kernels (warp_walk here,
// warp_sweep in cluster_intersect.cu). Each lane owns ray r and its best hit
// b; bit k of `pending` says lane k holds a leaf (`leaf` >= 0: clusters
// leaf * leaf_span onward of ls). All 32 lanes must call it together, with
// the same `pending`; lanes without a leaf help. For each such lane k, in
// lane order:
//   (b) k's ray and best hit are broadcast, and the 32 lanes test the
//       leaf's clusters against it, 32 triangles a round, lane j reading
//       column j of each of the nine rows: one 128-byte line per row a
//       round;
//   (c) closest: each lane keeps the lexicographic minimum of (t, prim)
//       over its triangles' hits that beat k's best; a 5-step xor shuffle
//       takes the minimum over the warp, and k takes it. That is the
//       minimum k's own in-order loop would keep, whatever order the tests
//       ran in. Any hit: a ballot of hits in (t_min, t_max) sets k's
//       b.occluded, which ends its query.
// On return every lane's leaf is -1.
template <bool ANY_HIT>
__device__ __forceinline__ void warp_leaves(const Ray& r, Best& b, int& leaf,
                                            unsigned pending,
                                            const LeafStore& ls,
                                            int leaf_span) {
  const int lane = threadIdx.x & (WARP - 1);
  const long long s = ls.stride;
  do {
    // (b) lane k's leaf against lane k's ray
    const int k = __ffs(pending) - 1;
    pending &= pending - 1;
    const float ox = __shfl_sync(FULL_MASK, r.ox, k);
    const float oy = __shfl_sync(FULL_MASK, r.oy, k);
    const float oz = __shfl_sync(FULL_MASK, r.oz, k);
    const float dx = __shfl_sync(FULL_MASK, r.dx, k);
    const float dy = __shfl_sync(FULL_MASK, r.dy, k);
    const float dz = __shfl_sync(FULL_MASK, r.dz, k);
    const float tmin = __shfl_sync(FULL_MASK, r.tmin, k);
    const float bt = __shfl_sync(FULL_MASK, b.t, k);
    const int bp = __shfl_sync(FULL_MASK, b.prim, k);
    const int blk = __shfl_sync(FULL_MASK, leaf, k);
    float ct = __int_as_float(0x7f800000), cu = 0.f, cv = 0.f;
    int cp = INT_MAX;
    bool hit = false;
    for (int j = 0; j < leaf_span && !hit; ++j) {
      const int c = blk * leaf_span + j;
      if (c >= ls.n_clusters) break;
      const float* col =
          ls.blocks + (long long)(ls.tile_base + c) * TRI_TILE + lane;
#pragma unroll
      for (int q = 0; q < TRI_TILE; q += WARP) {
        const float* p = col + q;
        float t, u, v;
        const int local = c * TRI_TILE + q + lane;
        const bool ok =
            mt_test(ox, oy, oz, dx, dy, dz, tmin, __ldg(p), __ldg(p + s),
                    __ldg(p + 2 * s), __ldg(p + 3 * s), __ldg(p + 4 * s),
                    __ldg(p + 5 * s), __ldg(p + 6 * s), __ldg(p + 7 * s),
                    __ldg(p + 8 * s), t, u, v) &&
            local < ls.n_real;
        if (ANY_HIT) {
          hit = __any_sync(FULL_MASK, ok && t < bt);
          if (hit) break;
        } else {
          const int prim = ls.prim_base + local;
          if (ok && (t < bt || (t == bt && prim < bp)) &&
              (t < ct || (t == ct && prim < cp))) {
            ct = t;
            cu = u;
            cv = v;
            cp = prim;
          }
        }
      }
    }
    // (c) reduce to lane k
    if (ANY_HIT) {
      if (lane == k && hit) b.occluded = true;
    } else if (__any_sync(FULL_MASK, cp != INT_MAX)) {
#pragma unroll
      for (int off = WARP / 2; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(FULL_MASK, ct, off);
        const int op = __shfl_xor_sync(FULL_MASK, cp, off);
        const float ou = __shfl_xor_sync(FULL_MASK, cu, off);
        const float ov = __shfl_xor_sync(FULL_MASK, cv, off);
        if (ot < ct || (ot == ct && op < cp)) {
          ct = ot;
          cp = op;
          cu = ou;
          cv = ov;
        }
      }
      if (lane == k) {  // every candidate beat k's best, so the least does
        b.t = ct;
        b.u = cu;
        b.v = cv;
        b.prim = cp;
      }
    }
    if (lane == k) leaf = -1;
  } while (pending);
}

// The warp-cooperative walk of one tree (the flat scene's, or one
// instance's prototype). Each lane owns ray r, its best hit b and a stack
// of `sp` refs; a lane with sp == 0 (no ray, a dead or finished ray) takes
// part as a helper. All 32 lanes of the warp must call it together, and
// every lane stays in it until the warp is done. Until no lane holds a
// leaf:
//   (a) each lane without a pending leaf pops refs, slab-testing inner
//       nodes, until it holds a leaf or its stack is empty;
//   (b), (c) the warp tests the pending leaves (warp_leaves); a lane whose
//       any-hit query ended empties its stack.
// So each ray visits the same nodes and leaves in the same order, with the
// same best t at each slab test, as a walk by one thread.
template <bool ANY_HIT>
__device__ __forceinline__ void warp_walk(const Ray& r, Best& b, int* stack,
                                          int sp,
                                          const float4* __restrict__ nodes,
                                          const LeafStore& ls, int leaf_span) {
  const bool neg_x = r.dx < 0.f, neg_y = r.dy < 0.f, neg_z = r.dz < 0.f;
  int leaf = -1;
  while (true) {
    // (a) traverse to the next leaf
    while (leaf < 0 && sp > 0) {
      const int ref = stack[--sp];
      if (ref < 0) {
        leaf = -ref - 1;
      } else {
        push_children(r, neg_x, neg_y, neg_z, nodes, ref, b.t, stack, sp);
      }
    }
    const unsigned pending = __ballot_sync(FULL_MASK, leaf >= 0);
    if (pending == 0) break;
    warp_leaves<ANY_HIT>(r, b, leaf, pending, ls, leaf_span);
    if (ANY_HIT && b.occluded) sp = 0;
  }
}

// The instance's affine w2o rows (m[0..11]) applied to a world ray in the
// reference's operation order (pallas_tree.py:534-540). The direction stays
// unnormalized, so object-space t is world t and best_t prunes across
// instances.
__device__ __forceinline__ Ray to_object(const Ray& w, const float* m) {
  return make_ray(m[0] * w.ox + m[1] * w.oy + m[2] * w.oz + m[3],
                  m[4] * w.ox + m[5] * w.oy + m[6] * w.oz + m[7],
                  m[8] * w.ox + m[9] * w.oy + m[10] * w.oz + m[11],
                  m[0] * w.dx + m[1] * w.dy + m[2] * w.dz,
                  m[4] * w.dx + m[5] * w.dy + m[6] * w.dz,
                  m[8] * w.dx + m[9] * w.dy + m[10] * w.dz, w.tmin);
}

// One instance row of the [I, 20] float table: world box lo(0:3) hi(3:6),
// w2o rows (6:18), pad; five 16-byte loads.
struct InstanceRow {
  float lo[3], hi[3], m[12];
};

__device__ __forceinline__ InstanceRow load_instance(const float4* instf,
                                                     int inst) {
  const float4* q = instf + 5 * (long long)inst;
  const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  const float4 d = __ldg(q + 3), e = __ldg(q + 4);
  InstanceRow row;
  row.lo[0] = a.x; row.lo[1] = a.y; row.lo[2] = a.z;
  row.hi[0] = a.w; row.hi[1] = b.x; row.hi[2] = b.y;
  row.m[0] = b.z;  row.m[1] = b.w;  row.m[2] = c.x;  row.m[3] = c.y;
  row.m[4] = c.z;  row.m[5] = c.w;  row.m[6] = d.x;  row.m[7] = d.y;
  row.m[8] = d.z;  row.m[9] = d.w;  row.m[10] = e.x; row.m[11] = e.y;
  return row;
}

inline int launch_blocks(long long n) { return (int)((n + BLOCK - 1) / BLOCK); }

}  // namespace akr
