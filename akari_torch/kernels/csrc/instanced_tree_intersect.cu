// Two-level instanced tree walk for Hopper: one lane per ray, each warp
// stepping through the instances together and testing its lanes' leaves
// together.
//
// Replaces the TPU kernel akari_tpu/ops/pallas_tree.py::_instanced_tree_kernel
// (launched by `run_instanced_tree`, pl.pallas_call at pallas_tree.py:690),
// in its closest-hit and any-hit variants: the route of every two-level
// instanced scene compiled with tree tables.
//
// What it computes. Each prototype mesh is stored once in object space;
// its 128-triangle clusters, padded with zero columns to whole clusters,
// are columns of the [9, sum Kp*128] component-major store `blocks` (rows
// 0-8 of the reference's inst_tris16: v0.xyz e1.xyz e2.xyz), and its BVH2
// over leaf_span-cluster blocks is a range of the concatenated [sum Nn, 16]
// node table. Instance i has a row of the [I, 20] float table (world box lo
// 0:3, hi 3:6, w2o rows 6:18) and of the [I, 8] int table (2 supercluster
// base, 1 real supercluster count, 2 cluster base, 3 n_clusters, 4
// tile_base, 5 prim_base, 6 tree_base, 7 pad). Each ray takes the instances
// in index order, as the reference does:
//   cull   slab test of the world ray against the instance's world box with
//          (t_min, best_t) and the reference's clamp and best_t > t_min rule;
//   move   w2o applied to origin and direction in the reference's operation
//          order, the direction left unnormalized, so object t is world t
//          and best_t prunes across instances;
//   walk   the prototype's tree at node row tree_base with a stack of
//          STACK_DEPTH refs, near child first by THIS ray's object-space
//          direction sign on the split axis (the TPU kernel orders by the
//          tile's ray 0);
//   leaves Moller-Trumbore over leaf_span clusters, k < n_clusters, columns
//          128 (tile_base + k) onward; a hit records the VIRTUAL prim id
//          prim_base + 128 k + j (scene/geom.py decodes it).
//   closest: best_t from min(t_max, T_MAX); ties go to the lower virtual
//     id, also across instances (ray_common.cuh). A miss gives prim -1,
//     t = T_MAX, u = v = 0.
//   any-hit: the first hit in (t_min, t_max) ends the ray.
// The TPU kernel's 4-bit per-subtile leaf mask (pallas_tree.py:491-504) is
// a tile artefact and has no counterpart: each ray's answer depends on that
// ray alone.
//
// What bounded the earlier one-thread-per-ray design. Each
// lane ran its own loop over all instances and its own 128-test leaves,
// reading a 48-byte row of a [sum Kp*128, 12] store per test: lanes of one
// warp walked different prototypes' trees at the same time, the
// instance-row loads stopped being broadcasts, each warp-wide row load
// touched up to 32 lines, and dead or finished lanes idled.
//
// Design. The TPU kernel culls and walks a 512-ray tile per instance with
// triangles on its lanes; here the warp steps through instances 0..I-1
// together, in index order. Each instance row is one broadcast load; each
// lane culls with its own best t and, on a hit, moves its ray into object
// space; then the warp runs ray_common.cuh's warp_walk over that
// prototype's tree (lanes traverse on their own, then test each pending
// leaf together, 32 triangles a round, one 128-byte line per component,
// and a (t, prim) shuffle reduction to the owner). Per ray the sequence
// of culls, walks and leaf tests is the one-thread walk's, so answers and
// work counts are unchanged. One prototype's tables (a 32k-triangle
// terrain: 1.1 MB of triangles, 33 KB of nodes) stay in L2 for every
// instance.
//
// What bounds it now. 5.9x faster than the one-thread design at the fused
// launch (PERF.md). Per leaf, the full-width Moller-Trumbore rounds of
// tree_intersect.cu's note; per instance a warp enters, the slowest lane's
// traversal before each round of leaves; per ray, I world-box slab tests
// for the loop over every instance (a TLAS walk is the next step, ROADMAP).
//
// Arithmetic. Built with --fmad=false and IEEE division, so the kernel
// equals its plain PyTorch version (ops/instanced_tree_intersect.py) bit
// for bit.

#include "ray_common.cuh"

namespace {

using namespace akr;

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
instanced_tree_kernel(const float* __restrict__ rays, long long n,
                      const float4* __restrict__ instf,
                      const int4* __restrict__ insti, int n_inst,
                      const float4* __restrict__ nodes,
                      const float* __restrict__ blocks, long long stride,
                      int leaf_span, float* __restrict__ t_out,
                      float* __restrict__ u_out, float* __restrict__ v_out,
                      int* __restrict__ prim_out,
                      unsigned char* __restrict__ occ_out) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = i < n;  // lanes past n help the others
  float tmax;
  const Ray w = load_ray(rays, n, valid ? i : 0, &tmax);
  Best best = init_best<ANY_HIT>(tmax);
  int stack[STACK_DEPTH];

  for (int inst = 0; inst < n_inst; ++inst) {  // warp-uniform
    const InstanceRow row = load_instance(instf, inst);
    const bool enter = valid && !best.occluded &&
                       slab(w, row.lo[0], row.lo[1], row.lo[2], row.hi[0],
                            row.hi[1], row.hi[2], best.t);
    if (!__any_sync(FULL_MASK, enter)) continue;
    const Ray r = to_object(w, row.m);
    const int4 ia = __ldg(insti + 2 * inst), ib = __ldg(insti + 2 * inst + 1);
    const LeafStore ls{blocks, stride, ia.w, ia.w * TRI_TILE, ib.x, ib.y};
    stack[0] = 0;  // the prototype's root
    warp_walk<ANY_HIT>(r, best, stack, enter ? 1 : 0,
                       nodes + 4 * (long long)ib.z, ls, leaf_span);
  }
  if (valid) store_best<ANY_HIT>(best, i, t_out, u_out, v_out, prim_out, occ_out);
}

template <bool ANY_HIT>
int launch(const float* rays, long long n, const float* instf,
           const int* insti, int n_inst, const float* nodes,
           const float* blocks, long long stride, int leaf_span, float* t_out,
           float* u_out, float* v_out, int* prim_out, unsigned char* occ_out,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  instanced_tree_kernel<ANY_HIT><<<launch_blocks(n), BLOCK, 0,
                                   (cudaStream_t)stream>>>(
      rays, n, (const float4*)instf, (const int4*)insti, n_inst,
      (const float4*)nodes, blocks, stride, leaf_span, t_out, u_out, v_out,
      prim_out, occ_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Closest hit. rays: [8, n] f32 contiguous; instf [n_inst, 20] f32; insti
// [n_inst, 8] i32; nodes [sum Nn, 16] f32; all 16-byte aligned; blocks
// [9, stride] f32 component-major triangles, stride = sum Kp*128. Outputs
// [n]. Returns the launch's cudaError_t.
int akr_instanced_tree_closest(const float* rays, long long n,
                               const float* instf, const int* insti,
                               int n_inst, const float* nodes,
                               const float* blocks, long long stride,
                               int leaf_span, float* t_out, float* u_out,
                               float* v_out, int* prim_out, int device,
                               void* stream) {
  return launch<false>(rays, n, instf, insti, n_inst, nodes, blocks, stride,
                       leaf_span, t_out, u_out, v_out, prim_out, nullptr,
                       device, stream);
}

// Any hit. Same inputs; occ_out [n] bytes (0/1), written into a bool tensor.
int akr_instanced_tree_anyhit(const float* rays, long long n,
                              const float* instf, const int* insti,
                              int n_inst, const float* nodes,
                              const float* blocks, long long stride,
                              int leaf_span, unsigned char* occ_out,
                              int device, void* stream) {
  return launch<true>(rays, n, instf, insti, n_inst, nodes, blocks, stride,
                      leaf_span, nullptr, nullptr, nullptr, nullptr, occ_out,
                      device, stream);
}

}  // extern "C"
