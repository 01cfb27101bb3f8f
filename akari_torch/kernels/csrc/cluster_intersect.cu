// Linear supercluster -> cluster -> triangle sweeps for Hopper: one lane per
// ray, each lane advancing its own sweep cursor, each warp testing its
// lanes' hit clusters together. The flat and the instanced kernels of scenes
// compiled without a tree table.
//
// Replaces the TPU kernels
//   akari_tpu/ops/pallas_cluster.py::_cluster_kernel (`run_clustered`,
//     pl.pallas_call at pallas_cluster.py:468): flat scenes whose tri_tree
//     is None;
//   akari_tpu/ops/pallas_cluster.py::_instanced_kernel (`run_instanced`,
//     pl.pallas_call at pallas_cluster.py:428): two-level scenes whose
//     tri_tree is None;
// each in its closest-hit and any-hit variants.
//
// What they compute. Triangles in storage order form clusters of 128 and
// clusters form superclusters of 32; each level has an [*, 8] box table
// (lo.xyz, hi.xyz, pad, pad; bvh/cluster_tree.py). The triangles are the
// component-major store the tree walks read: [9, stride] floats, v0.xyz
// e1.xyz e2.xyz on the rows, one triangle per column (rows 0-8 of the
// reference's pack_tris_t / inst_tris16 layouts). Per ray:
//   flat       for each real supercluster s: slab test its box; on a hit,
//              for each of its 32 clusters k < n_clusters: slab test the
//              cluster box; on a hit, Moller-Trumbore over the cluster's
//              columns 128 k onward (real-count guard on the last); a hit
//              records storage prim 128 k + j.
//   instanced  for each instance in index order: the world-box cull and the
//              w2o transform of the instanced tree walk, then the flat sweep
//              over the prototype's superclusters sup_base .. sup_base +
//              s_real - 1 (the REAL count, int slot 1), clusters cl_base + k
//              for k < n_clusters (slot 3) and columns 128 (tile_base + k)
//              onward (slot 4; zero padding columns never hit); a hit
//              records the virtual prim prim_base + 128 k + j (slot 5).
// Every box test uses the ray's current best_t. The TPU kernels test a
// whole 512-ray tile against boxes with a best_t read at a supercluster's
// entry; those descent flags only prune, so the per-ray sweep is the same
// function. Closest hit, tie rule and any-hit exit as in ray_common.cuh.
//
// What bounded the earlier one-thread-per-ray design (11.2 / 28.4 ms
// closest at the fused launch, ~50x the bound, on an NVIDIA H100 80GB
// HBM3 at 700 W; PERF.md). Each lane ran each hit cluster's 128 tests
// alone, reading 48-byte rows of a [T, 12] row store. The fused launch's secondary rays put a warp's lanes in
// different clusters, so a warp-wide row load touched up to 32 lines; the
// lanes whose ray was dead (47-64 % of the fused launch) or whose
// supercluster missed sat idle while one lane ran 128 tests, and in the
// instanced kernel the per-lane cull made the whole sweep divergent.
//
// Design: the tree walks' mechanism (ray_common.cuh) with a sweep cursor in
// place of a stack. Each lane owns a ray, its best hit and a cursor (s, j)
// over its superclusters and clusters, and advances it on its own, with
// its own live best t, until it holds a hit cluster or is done: the
// sequence of box tests of the one-thread sweep and of the plain version,
// so answers and work counts are unchanged. Then the warp tests each
// pending lane's cluster together (warp_leaves: one leaf is one cluster),
// 32 triangles a round, one 128-byte line per component, and a (t, prim)
// shuffle reduction (any hit: a ballot) hands the owner its answer.
// Dead, finished and past-n lanes stay in the loop as helpers; every
// intrinsic runs with the full mask. The instanced kernel steps the warp
// through the instances together (broadcast instance-row loads, a per-lane
// cull against the live best t, __any_sync to skip an instance no lane
// enters) and sweeps each entered prototype cooperatively. Box rows are
// 32-byte __ldg loads; a prototype's tables stay in L2.
//
// What bounds it now: 4.2x / 5.5x faster than the one-thread design at
// the fused launch and 11-12x its operation bound (2.7 / 5.2 ms closest,
// same card; PERF.md). Left: the per-lane box tests of step (a), which
// grow linearly with the scene (every real supercluster box, 32 cluster
// boxes per supercluster hit) while lanes that hold a cluster wait at the
// ballot, then the full-width Moller-Trumbore rounds of the leaf tests.
// It is the fallback for tables without a tree, not the main route.
//
// Arithmetic. Built with --fmad=false and IEEE division, so each kernel
// equals its plain PyTorch version (ops/cluster_intersect.py) bit for bit.

#include "ray_common.cuh"

namespace {

using namespace akr;

// The warp-cooperative sweep of one supercluster -> cluster hierarchy (the
// flat scene's, or one instance's prototype): `supers` and `clusters` start
// at the mesh's first rows, `n_sup` is its real supercluster count and ls
// its clusters' triangles. A lane with `active` false takes part as a
// helper. All 32 lanes of the warp must call it together. Until no lane
// holds a cluster:
//   (a) each lane without a pending cluster advances its cursor: supercluster
//       s's box (j < 0), then cluster s * SUPER + j's box, until a cluster
//       box is hit or every supercluster is done;
//   (b), (c) the warp tests the pending clusters (warp_leaves, leaf_span 1);
//       a lane whose any-hit query ended moves its cursor to the end.
template <bool ANY_HIT>
__device__ __forceinline__ void warp_sweep(const Ray& r, Best& b, bool active,
                                           const float4* __restrict__ supers,
                                           int n_sup,
                                           const float4* __restrict__ clusters,
                                           const LeafStore& ls) {
  int s = active ? 0 : n_sup;
  int j = -1;  // cluster s * SUPER + j of supercluster s; -1: s's own box
  int leaf = -1;
  while (true) {
    // (a) advance to the next hit cluster
    while (leaf < 0 && s < n_sup) {
      if (j < 0) {
        if (slab_row(r, supers + 2 * (long long)s, b.t)) {
          j = 0;
        } else {
          ++s;
        }
      } else {
        const int k = s * SUPER + j;
        if (slab_row(r, clusters + 2 * (long long)k, b.t)) leaf = k;
        if (++j == SUPER || k + 1 >= ls.n_clusters) {
          j = -1;
          ++s;
        }
      }
    }
    const unsigned pending = __ballot_sync(FULL_MASK, leaf >= 0);
    if (pending == 0) break;
    warp_leaves<ANY_HIT>(r, b, leaf, pending, ls, 1);
    if (ANY_HIT && b.occluded) s = n_sup;
  }
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
cluster_kernel(const float* __restrict__ rays, long long n,
               const float4* __restrict__ supers,
               const float4* __restrict__ clusters,
               const float* __restrict__ blocks, long long stride, int n_tris,
               float* __restrict__ t_out, float* __restrict__ u_out,
               float* __restrict__ v_out, int* __restrict__ prim_out,
               unsigned char* __restrict__ occ_out) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = i < n;  // lanes past n help the others
  float tmax;
  const Ray r = load_ray(rays, n, valid ? i : 0, &tmax);
  Best best = init_best<ANY_HIT>(tmax);
  const int n_cl = (n_tris + TRI_TILE - 1) / TRI_TILE;
  const LeafStore ls{blocks, stride, n_cl, n_tris, 0, 0};
  warp_sweep<ANY_HIT>(r, best, valid, supers, (n_cl + SUPER - 1) / SUPER,
                      clusters, ls);
  if (valid) store_best<ANY_HIT>(best, i, t_out, u_out, v_out, prim_out, occ_out);
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
instanced_cluster_kernel(const float* __restrict__ rays, long long n,
                         const float4* __restrict__ instf,
                         const int4* __restrict__ insti, int n_inst,
                         const float4* __restrict__ supers,
                         const float4* __restrict__ clusters,
                         const float* __restrict__ blocks, long long stride,
                         float* __restrict__ t_out, float* __restrict__ u_out,
                         float* __restrict__ v_out, int* __restrict__ prim_out,
                         unsigned char* __restrict__ occ_out) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = i < n;  // lanes past n help the others
  float tmax;
  const Ray w = load_ray(rays, n, valid ? i : 0, &tmax);
  Best best = init_best<ANY_HIT>(tmax);
  for (int inst = 0; inst < n_inst; ++inst) {  // warp-uniform
    const InstanceRow row = load_instance(instf, inst);
    const bool enter = valid && !best.occluded &&
                       slab(w, row.lo[0], row.lo[1], row.lo[2], row.hi[0],
                            row.hi[1], row.hi[2], best.t);
    if (!__any_sync(FULL_MASK, enter)) continue;
    const Ray r = to_object(w, row.m);
    // (sup_base, s_real, cl_base, n_clusters), (tile_base, prim_base, ...);
    // the prototype's clusters are whole: n_real = 128 n_clusters
    const int4 ia = __ldg(insti + 2 * inst), ib = __ldg(insti + 2 * inst + 1);
    const LeafStore ls{blocks, stride, ia.w, ia.w * TRI_TILE, ib.x, ib.y};
    warp_sweep<ANY_HIT>(r, best, enter, supers + 2 * (long long)ia.x, ia.y,
                        clusters + 2 * (long long)ia.z, ls);
  }
  if (valid) store_best<ANY_HIT>(best, i, t_out, u_out, v_out, prim_out, occ_out);
}

}  // namespace

extern "C" {

// Flat closest hit. rays: [8, n] f32 contiguous; supers [Spad, 8], clusters
// [Kpad, 8] f32, 16-byte aligned; blocks [9, stride] f32 component-major
// triangles, stride a multiple of 128 and >= n_tris. Outputs [n]. Returns
// the launch's cudaError_t.
int akr_cluster_closest(const float* rays, long long n, const float* supers,
                        const float* clusters, const float* blocks,
                        long long stride, int n_tris, float* t_out,
                        float* u_out, float* v_out, int* prim_out, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  cluster_kernel<false><<<launch_blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
      rays, n, (const float4*)supers, (const float4*)clusters, blocks, stride,
      n_tris, t_out, u_out, v_out, prim_out, nullptr);
  return (int)cudaGetLastError();
}

// Flat any hit; occ_out [n] bytes (0/1), written into a bool tensor.
int akr_cluster_anyhit(const float* rays, long long n, const float* supers,
                       const float* clusters, const float* blocks,
                       long long stride, int n_tris, unsigned char* occ_out,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  cluster_kernel<true><<<launch_blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
      rays, n, (const float4*)supers, (const float4*)clusters, blocks, stride,
      n_tris, nullptr, nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

// Instanced closest hit. instf [n_inst, 20] f32, insti [n_inst, 8] i32,
// supers/clusters the concatenated per-prototype tables, blocks [9, stride]
// f32 component-major, stride = sum Kp*128.
int akr_instanced_cluster_closest(const float* rays, long long n,
                                  const float* instf, const int* insti,
                                  int n_inst, const float* supers,
                                  const float* clusters, const float* blocks,
                                  long long stride, float* t_out,
                                  float* u_out, float* v_out, int* prim_out,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  instanced_cluster_kernel<false><<<launch_blocks(n), BLOCK, 0,
                                    (cudaStream_t)stream>>>(
      rays, n, (const float4*)instf, (const int4*)insti, n_inst,
      (const float4*)supers, (const float4*)clusters, blocks, stride, t_out,
      u_out, v_out, prim_out, nullptr);
  return (int)cudaGetLastError();
}

// Instanced any hit; occ_out [n] bytes (0/1).
int akr_instanced_cluster_anyhit(const float* rays, long long n,
                                 const float* instf, const int* insti,
                                 int n_inst, const float* supers,
                                 const float* clusters, const float* blocks,
                                 long long stride, unsigned char* occ_out,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  instanced_cluster_kernel<true><<<launch_blocks(n), BLOCK, 0,
                                   (cudaStream_t)stream>>>(
      rays, n, (const float4*)instf, (const int4*)insti, n_inst,
      (const float4*)supers, (const float4*)clusters, blocks, stride, nullptr,
      nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
