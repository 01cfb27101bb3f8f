// BVH2 tree-walk ray-triangle intersection for Hopper, one thread per ray.
//
// Replaces the TPU kernel akari_tpu/ops/pallas_tree.py::_tree_kernel
// (launched by `run_tree`, pl.pallas_call at pallas_tree.py:433), in its
// closest-hit and any-hit variants, for flat scenes above DENSE_MAX_TRIS.
//
// What it computes. The scene's triangles, in storage order, form clusters
// of TRI_TILE (128); `leaf_span` consecutive clusters form a leaf block; a
// binned-SAH BVH2 over the leaf blocks is the [Nn, 16] node table of
// akari_torch/bvh/cluster_tree.py (pallas_tree.py:21-31 layout):
//   0:3 child0 lo, 3:6 child0 hi, 6:9 child1 lo, 9:12 child1 hi,
//   12 child0 ref, 13 child1 ref, 14 split axis, 15 pad;
// ref >= 0 is an inner row, ref < 0 is leaf block -ref - 1.
// Each ray walks the tree with a stack of refs: pop; for an inner node,
// slab-test both children against the ray's live best t (the reference's
// formula: 1/d with |d| clamped to 1e-12, near <= far, and best_t > t_min,
// which culls dead rays with t_max <= t_min at the root); push the far child,
// then the near one, near/far taken from THIS ray's direction sign on the
// node's split axis; for a leaf, run Moller-Trumbore over its clusters'
// triangles (real-count guard on the last cluster), in the operation order
// of `_pairwise_mt_t` (pallas_intersect.py:56-90).
//   closest: best t starts at min(t_max, T_MAX) (the bounded-query contract
//     of the fused shadow+extension launch); a hit is taken when
//     t < best_t || (t == best_t && prim < best_prim). That tie rule makes
//     the answer the lowest-index triangle among the exact minima whatever
//     order the walk visits leaves in: the dense kernel's and the brute
//     oracle's answer. (The Pallas walk keeps whichever cluster its tile
//     visits first; a stated divergence, ROADMAP Queue 3.) A miss gives
//     prim -1, t = T_MAX, u = v = 0.
//   any-hit: 1 at the first triangle hit in (t_min, t_max), else 0.
// A ray with a NaN component never hits (every Moller-Trumbore test fails),
// so fmaxf/fminf in the slab test, which drop NaNs where the reference's
// maximum/minimum keep them, change which boxes such a ray enters but
// never an output.
//
// Design. The TPU kernel walks a 512-ray tile with one scalar stack in
// SMEM, per-128-ray subtile masks and a 1-deep leaf DMA pipeline: answers
// to VMEM and lane constraints Hopper does not have. Here each thread owns
// a ray and an int32 stack of STACK_DEPTH refs in local memory (the host
// asserts tree depth + 1 <= STACK_DEPTH when it builds the table, so no
// overflow check is needed). Node rows (64 B) and triangle rows (48 B of
// the [T, 12] store) are read as 16-byte __ldg loads through the read-only
// cache; the 261 KB node table of a 522k-triangle scene stays in L2. The
// packed store, rather than the first 48 B of each 128 B prim_table row,
// makes the kernel 14-16 % faster at the fused launch (PERF.md).
//
// Arithmetic. Built with --fmad=false and IEEE division, so the kernel
// equals its plain PyTorch version (ops/tree_intersect.py) bit for bit.
//
// What bounds it on the H100. Leaves are 128-triangle clusters, so a ray
// spends most of its time in dense Moller-Trumbore work (~40 float ops per
// test, ~128 tests per leaf entered) rather than in node reads; warps
// diverge where their rays enter different leaves (sorting the rays by a
// coherence key first, as the reference does, cuts kernel time by ~10 %
// but costs as much as it saves; PERF.md). A leaf is 6 KB of triangles,
// shared through L1/L2 by the rays of a warp that enter it. A per-cluster
// sub-tree, wide nodes and persistent threads are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;         // threads (rays) per block
constexpr int STACK_DEPTH = 64;    // refs per ray (cluster_tree.STACK_DEPTH)
constexpr int TRI_TILE = 128;      // triangles per cluster
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

// pallas_tree.py slab_mask, per ray
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

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
tree_intersect_kernel(const float* __restrict__ rays, long long n,
                      const float4* __restrict__ nodes,
                      const float4* __restrict__ tris, int n_tris,
                      int leaf_span, float* __restrict__ t_out,
                      float* __restrict__ u_out, float* __restrict__ v_out,
                      int* __restrict__ prim_out,
                      unsigned char* __restrict__ occ_out) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = rays[i];
  r.oy = rays[n + i];
  r.oz = rays[2 * n + i];
  r.dx = rays[3 * n + i];
  r.dy = rays[4 * n + i];
  r.dz = rays[5 * n + i];
  r.tmin = rays[6 * n + i];
  const float tmax = rays[7 * n + i];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  const bool neg_x = r.dx < 0.f, neg_y = r.dy < 0.f, neg_z = r.dz < 0.f;
  const int n_clusters = (n_tris + TRI_TILE - 1) / TRI_TILE;

  // init_state: best_t = minimum(t_max, T_MAX) (NaN stays NaN: never hits)
  float best_t = ANY_HIT ? tmax : (tmax > T_MAX ? T_MAX : tmax);
  float best_u = 0.f, best_v = 0.f;
  int best_prim = -1;
  bool occluded = false;

  int stack[STACK_DEPTH];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int ref = stack[--sp];
    if (ref >= 0) {
      const float4* row = nodes + 4 * (long long)ref;
      const float4 a = __ldg(row), b = __ldg(row + 1);
      const float4 c = __ldg(row + 2), e = __ldg(row + 3);
      const bool h0 = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, best_t);
      const bool h1 = slab(r, b.z, b.w, c.x, c.y, c.z, c.w, best_t);
      const int c0 = (int)e.x, c1 = (int)e.y, ax = (int)e.z;
      const bool neg = ax == 0 ? neg_x : (ax == 1 ? neg_y : neg_z);
      const int near_ref = neg ? c1 : c0, far_ref = neg ? c0 : c1;
      const bool near_hit = neg ? h1 : h0, far_hit = neg ? h0 : h1;
      // far first so the near child pops first (front to back)
      if (far_hit) stack[sp++] = far_ref;
      if (near_hit) stack[sp++] = near_ref;
      continue;
    }
    const int blk = -ref - 1;
    for (int j = 0; j < leaf_span; ++j) {
      const int k = blk * leaf_span + j;
      if (k >= n_clusters) break;
      const int first = k * TRI_TILE;
      const int last = min(first + TRI_TILE, n_tris);
      for (int p = first; p < last; ++p) {
        const float4* tr = tris + 3 * (long long)p;
        const float4 ta = __ldg(tr), tb = __ldg(tr + 1), tc = __ldg(tr + 2);
        const float v0x = ta.x, v0y = ta.y, v0z = ta.z;
        const float e1x = ta.w, e1y = tb.x, e1z = tb.y;
        const float e2x = tb.z, e2y = tb.w, e2z = tc.x;
        // pvec = d x e2
        const float px = r.dy * e2z - r.dz * e2y;
        const float py = r.dz * e2x - r.dx * e2z;
        const float pz = r.dx * e2y - r.dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float inv_det = 1.0f / (fabsf(det) < HIT_EPS ? 1.0f : det);
        const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        // qvec = tvec x e1
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool ok = (fabsf(det) >= HIT_EPS) && (u >= 0.f) && (v >= 0.f) &&
                        (u + v <= 1.f) && (t > r.tmin);
        if (ANY_HIT) {
          if (ok && t < best_t) {
            occluded = true;
            break;
          }
        } else if (ok && (t < best_t || (t == best_t && p < best_prim))) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_prim = p;
        }
      }
      if (ANY_HIT && occluded) break;
    }
    if (ANY_HIT && occluded) break;
  }
  if (ANY_HIT) {
    occ_out[i] = occluded ? 1 : 0;
  } else {
    const bool valid = best_prim >= 0;
    t_out[i] = valid ? best_t : T_MAX;
    u_out[i] = best_u;
    v_out[i] = best_v;
    prim_out[i] = best_prim;
  }
}

int launch_blocks(long long n) { return (int)((n + BLOCK - 1) / BLOCK); }

}  // namespace

extern "C" {

// Closest hit. rays: [8, n] f32 contiguous (ox oy oz dx dy dz tmin tmax);
// nodes: [Nn, 16] f32 rows; tris: [n_tris, 12] f32 rows (v0 e1 e2 pad);
// both 16-byte aligned. Outputs [n]. Returns the launch's cudaError_t.
int akr_tree_closest(const float* rays, long long n, const float* nodes,
                     const float* tris, int n_tris, int leaf_span,
                     float* t_out, float* u_out, float* v_out, int* prim_out,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  tree_intersect_kernel<false><<<launch_blocks(n), BLOCK, 0,
                                 (cudaStream_t)stream>>>(
      rays, n, (const float4*)nodes, (const float4*)tris, n_tris, leaf_span,
      t_out, u_out, v_out, prim_out, nullptr);
  return (int)cudaGetLastError();
}

// Any hit. Same inputs; occ_out [n] bytes (0/1), written into a bool tensor.
int akr_tree_anyhit(const float* rays, long long n, const float* nodes,
                    const float* tris, int n_tris, int leaf_span,
                    unsigned char* occ_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  tree_intersect_kernel<true><<<launch_blocks(n), BLOCK, 0,
                                (cudaStream_t)stream>>>(
      rays, n, (const float4*)nodes, (const float4*)tris, n_tris, leaf_span,
      nullptr, nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
