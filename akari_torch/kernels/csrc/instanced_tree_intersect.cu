// Two-level instanced tree walk for Hopper, one thread per ray.
//
// Replaces the TPU kernel akari_tpu/ops/pallas_tree.py::_instanced_tree_kernel
// (launched by `run_instanced_tree`, pl.pallas_call at pallas_tree.py:690),
// in its closest-hit and any-hit variants: the route of every two-level
// instanced scene compiled with tree tables.
//
// What it computes. Each prototype mesh is stored once in object space;
// its 128-triangle clusters, padded with zero rows to whole clusters, are
// rows of the [sum Kp*128, 12] store `tris`, and its BVH2 over
// leaf_span-cluster blocks is a range of the concatenated [sum Nn, 16] node
// table. Instance i has a row of the [I, 20] float table (world box lo 0:3,
// hi 3:6, w2o rows 6:18) and of the [I, 8] int table (2 supercluster base,
// 1 real supercluster count, 2 cluster base, 3 n_clusters, 4 tile_base,
// 5 prim_base, 6 tree_base, 7 pad). Each ray takes the instances in index
// order, as the reference does:
//   cull   slab test of the world ray against the instance's world box with
//          (t_min, best_t) and the reference's clamp and best_t > t_min rule;
//   move   w2o applied to origin and direction in the reference's operation
//          order, the direction left unnormalized, so object t is world t
//          and best_t prunes across instances;
//   walk   the prototype's tree at node row tree_base with a stack of
//          STACK_DEPTH refs, near child first by THIS ray's object-space
//          direction sign on the split axis (the TPU kernel orders by the
//          tile's ray 0);
//   leaves Moller-Trumbore over leaf_span clusters, k < n_clusters, rows
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
// Design. The TPU kernel walks a 512-ray tile with one scalar stack in SMEM
// and streams each leaf's 6 KB into VMEM; here each thread owns a ray, an
// int32 stack in local memory (the host checks tree depth + 1 <=
// STACK_DEPTH) and its best hit in registers. Instance rows (80 B + 32 B)
// are read by every thread of a warp at once: one broadcast load each.
// Node rows and triangle rows are 16-byte __ldg loads through the read-only
// cache; one prototype's tables (a 32k-triangle terrain: 1.5 MB of
// triangles, 33 KB of nodes) stay in L2 for every instance.
//
// What bounds it on the H100. Operations: per ray, I world-box slab tests,
// a transform per box hit, then the prototype walk (~40 float ops per
// Moller-Trumbore test, 128 per cluster entered). Warps diverge where their
// rays enter different instances and leaves. The loop over all I
// instances costs I slab tests a ray; a TLAS walk (SceneArrays.bvh holds
// one) would cut that for large I if the hits stay equal: later work.
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
                      const float4* __restrict__ tris, int leaf_span,
                      float* __restrict__ t_out, float* __restrict__ u_out,
                      float* __restrict__ v_out, int* __restrict__ prim_out,
                      unsigned char* __restrict__ occ_out) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float tmax;
  const Ray w = load_ray(rays, n, i, &tmax);
  Best best = init_best<ANY_HIT>(tmax);
  int stack[STACK_DEPTH];

  for (int inst = 0; inst < n_inst; ++inst) {
    const InstanceRow row = load_instance(instf, inst);
    if (!slab(w, row.lo[0], row.lo[1], row.lo[2], row.hi[0], row.hi[1],
              row.hi[2], best.t))
      continue;
    const Ray r = to_object(w, row.m);
    const bool neg_x = r.dx < 0.f, neg_y = r.dy < 0.f, neg_z = r.dz < 0.f;
    const int4 ia = __ldg(insti + 2 * inst), ib = __ldg(insti + 2 * inst + 1);
    const int n_cl = ia.w, tile_base = ib.x, prim_base = ib.y;
    const float4* tnodes = nodes + 4 * (long long)ib.z;

    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const int ref = stack[--sp];
      if (ref >= 0) {
        const float4* nr = tnodes + 4 * (long long)ref;
        const float4 a = __ldg(nr), b = __ldg(nr + 1);
        const float4 c = __ldg(nr + 2), e = __ldg(nr + 3);
        const bool h0 = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, best.t);
        const bool h1 = slab(r, b.z, b.w, c.x, c.y, c.z, c.w, best.t);
        const int c0 = (int)e.x, c1 = (int)e.y, ax = (int)e.z;
        const bool neg = ax == 0 ? neg_x : (ax == 1 ? neg_y : neg_z);
        const int near_ref = neg ? c1 : c0, far_ref = neg ? c0 : c1;
        const bool near_hit = neg ? h1 : h0, far_hit = neg ? h0 : h1;
        if (far_hit) stack[sp++] = far_ref;
        if (near_hit) stack[sp++] = near_ref;
        continue;
      }
      const int blk = -ref - 1;
      for (int j = 0; j < leaf_span; ++j) {
        const int k = blk * leaf_span + j;
        if (k >= n_cl) break;
        if (tri_run<ANY_HIT>(r, tris, (long long)(tile_base + k) * TRI_TILE,
                             TRI_TILE, prim_base + k * TRI_TILE, best)) {
          store_best<ANY_HIT>(best, i, t_out, u_out, v_out, prim_out, occ_out);
          return;
        }
      }
    }
  }
  store_best<ANY_HIT>(best, i, t_out, u_out, v_out, prim_out, occ_out);
}

template <bool ANY_HIT>
int launch(const float* rays, long long n, const float* instf,
           const int* insti, int n_inst, const float* nodes, const float* tris,
           int leaf_span, float* t_out, float* u_out, float* v_out,
           int* prim_out, unsigned char* occ_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  instanced_tree_kernel<ANY_HIT><<<launch_blocks(n), BLOCK, 0,
                                   (cudaStream_t)stream>>>(
      rays, n, (const float4*)instf, (const int4*)insti, n_inst,
      (const float4*)nodes, (const float4*)tris, leaf_span, t_out, u_out,
      v_out, prim_out, occ_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Closest hit. rays: [8, n] f32 contiguous; instf [n_inst, 20] f32; insti
// [n_inst, 8] i32; nodes [sum Nn, 16] f32; tris [sum Kp*128, 12] f32; all
// 16-byte aligned. Outputs [n]. Returns the launch's cudaError_t.
int akr_instanced_tree_closest(const float* rays, long long n,
                               const float* instf, const int* insti,
                               int n_inst, const float* nodes,
                               const float* tris, int leaf_span, float* t_out,
                               float* u_out, float* v_out, int* prim_out,
                               int device, void* stream) {
  return launch<false>(rays, n, instf, insti, n_inst, nodes, tris, leaf_span,
                       t_out, u_out, v_out, prim_out, nullptr, device, stream);
}

// Any hit. Same inputs; occ_out [n] bytes (0/1), written into a bool tensor.
int akr_instanced_tree_anyhit(const float* rays, long long n,
                              const float* instf, const int* insti,
                              int n_inst, const float* nodes,
                              const float* tris, int leaf_span,
                              unsigned char* occ_out, int device,
                              void* stream) {
  return launch<true>(rays, n, instf, insti, n_inst, nodes, tris, leaf_span,
                      nullptr, nullptr, nullptr, nullptr, occ_out, device,
                      stream);
}

}  // extern "C"
