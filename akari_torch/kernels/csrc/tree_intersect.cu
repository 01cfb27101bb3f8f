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
// equals its plain PyTorch version (ops/tree_intersect.py) bit for bit. The
// slab and Moller-Trumbore tests are ray_common.cuh's, shared with the
// instanced and linear cluster kernels.
//
// What bounds it on the H100. Leaves are 128-triangle clusters, so a ray
// spends most of its time in dense Moller-Trumbore work (~40 float ops per
// test, ~128 tests per leaf entered) rather than in node reads; warps
// diverge where their rays enter different leaves (sorting the rays by a
// coherence key first, as the reference does, cuts kernel time by ~10 %
// but costs as much as it saves; PERF.md). A leaf is 6 KB of triangles,
// shared through L1/L2 by the rays of a warp that enter it. A per-cluster
// sub-tree, wide nodes and persistent threads are later work.

#include "ray_common.cuh"

namespace {

using namespace akr;

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
  float tmax;
  const Ray r = load_ray(rays, n, i, &tmax);
  const bool neg_x = r.dx < 0.f, neg_y = r.dy < 0.f, neg_z = r.dz < 0.f;
  const int n_clusters = (n_tris + TRI_TILE - 1) / TRI_TILE;
  Best best = init_best<ANY_HIT>(tmax);

  int stack[STACK_DEPTH];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int ref = stack[--sp];
    if (ref >= 0) {
      const float4* row = nodes + 4 * (long long)ref;
      const float4 a = __ldg(row), b = __ldg(row + 1);
      const float4 c = __ldg(row + 2), e = __ldg(row + 3);
      const bool h0 = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, best.t);
      const bool h1 = slab(r, b.z, b.w, c.x, c.y, c.z, c.w, best.t);
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
    bool done = false;
    for (int j = 0; j < leaf_span && !done; ++j) {
      const int k = blk * leaf_span + j;
      if (k >= n_clusters) break;
      const int first = k * TRI_TILE;
      done = tri_run<ANY_HIT>(r, tris, first, min(TRI_TILE, n_tris - first),
                              first, best);
    }
    if (done) break;
  }
  store_best<ANY_HIT>(best, i, t_out, u_out, v_out, prim_out, occ_out);
}

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
