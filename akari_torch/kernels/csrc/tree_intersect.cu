// BVH2 tree-walk ray-triangle intersection for Hopper: one lane per ray,
// each warp testing its lanes' leaves together.
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
// The triangles are the reference's component-major store `tri_blocks`
// (pack_tris_t layout, rows 0-8 kept): [9, Tpad] floats, v0.xyz e1.xyz
// e2.xyz on the rows, one triangle per column, zero columns to a multiple
// of 128.
//
// What bounded the earlier one-thread-per-ray design. Each
// lane ran its leaf's 128 tests alone, reading a 48-byte row of a [T, 12]
// store per test. The fused launch's secondary rays put the 32 lanes of a
// warp in up to 32 different leaves, so each warp-wide row load touched up
// to 32 lines: ~96 L1 wavefronts per 32 tests against ~15 SM-cycles of
// float issue for them. Lanes whose ray was dead (47-64 % of the fused
// launch) or finished idled until the warp's slowest ray was done.
//
// Design. The TPU kernel tests one triangle block against a 512-ray tile
// with triangles on its 128 lanes; here too triangles go on lanes. A lane
// owns a ray, its best hit and an int32 stack of STACK_DEPTH refs in local
// memory (the host asserts tree depth + 1 <= STACK_DEPTH). The walk is
// ray_common.cuh's warp_walk: lanes traverse inner nodes on their own until
// each holds a leaf; then, leaf by leaf, the owner's ray is broadcast and
// the 32 lanes test the leaf 32 triangles a round, reading each component
// of 32 consecutive triangles as one 128-byte line (9 wavefronts a round);
// a shuffle reduction of (t, prim) gives the owner the same answer as its
// own in-order loop. Lanes without a ray, dead or finished, stay in the loop
// and test the others' leaves. Node rows (64 B) are 16-byte __ldg loads;
// the 261 KB node table of a 522k-triangle scene stays in L2.
//
// What bounds it now. 4.5x faster than the one-thread design at the fused
// launch; dead lanes cost it 4-7 % (PERF.md). Per leaf the warp issues one
// Moller-Trumbore round per 32 triangles at full width: ~45 float
// operations without FMA contraction (--fmad=false halves the 67 TFLOP/s
// the bound divides by) and ~30 other instructions (nine loads, the compares
// and the candidate select), plus ~10 broadcasts and, where a triangle beats
// the owner's best, a 20-shuffle reduction. Traversal is still per lane:
// lanes wait at the ballot for the lane with the most inner nodes to pop.
// How the time splits between those is not measured yet.
//
// Arithmetic. Built with --fmad=false and IEEE division, so the kernel
// equals its plain PyTorch version (ops/tree_intersect.py) bit for bit.

#include "ray_common.cuh"

namespace {

using namespace akr;

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
tree_intersect_kernel(const float* __restrict__ rays, long long n,
                      const float4* __restrict__ nodes,
                      const float* __restrict__ blocks, long long stride,
                      int n_tris, int leaf_span, float* __restrict__ t_out,
                      float* __restrict__ u_out, float* __restrict__ v_out,
                      int* __restrict__ prim_out,
                      unsigned char* __restrict__ occ_out) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = i < n;  // lanes past n help the others
  float tmax;
  const Ray r = load_ray(rays, n, valid ? i : 0, &tmax);
  Best best = init_best<ANY_HIT>(tmax);
  int stack[STACK_DEPTH];
  stack[0] = 0;  // the root
  const LeafStore ls{blocks, stride, (n_tris + TRI_TILE - 1) / TRI_TILE,
                     n_tris, 0, 0};
  warp_walk<ANY_HIT>(r, best, stack, valid ? 1 : 0, nodes, ls, leaf_span);
  if (valid) store_best<ANY_HIT>(best, i, t_out, u_out, v_out, prim_out, occ_out);
}

}  // namespace

extern "C" {

// Closest hit. rays: [8, n] f32 contiguous (ox oy oz dx dy dz tmin tmax);
// nodes: [Nn, 16] f32 rows, 16-byte aligned; blocks: [9, stride] f32
// component-major triangles, stride a multiple of 128 and >= n_tris.
// Outputs [n]. Returns the launch's cudaError_t.
int akr_tree_closest(const float* rays, long long n, const float* nodes,
                     const float* blocks, long long stride, int n_tris,
                     int leaf_span, float* t_out, float* u_out, float* v_out,
                     int* prim_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  tree_intersect_kernel<false><<<launch_blocks(n), BLOCK, 0,
                                 (cudaStream_t)stream>>>(
      rays, n, (const float4*)nodes, blocks, stride, n_tris, leaf_span, t_out,
      u_out, v_out, prim_out, nullptr);
  return (int)cudaGetLastError();
}

// Any hit. Same inputs; occ_out [n] bytes (0/1), written into a bool tensor.
int akr_tree_anyhit(const float* rays, long long n, const float* nodes,
                    const float* blocks, long long stride, int n_tris,
                    int leaf_span, unsigned char* occ_out, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  tree_intersect_kernel<true><<<launch_blocks(n), BLOCK, 0,
                                (cudaStream_t)stream>>>(
      rays, n, (const float4*)nodes, blocks, stride, n_tris, leaf_span,
      nullptr, nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
