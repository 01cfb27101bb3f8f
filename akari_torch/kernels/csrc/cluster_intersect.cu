// Linear supercluster -> cluster -> triangle sweeps for Hopper, one thread
// per ray: the flat and the instanced kernels of scenes compiled without a
// tree table.
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
// (lo.xyz, hi.xyz, pad, pad; bvh/cluster_tree.py). Per ray:
//   flat       for each real supercluster s: slab test its box; on a hit,
//              for each of its 32 clusters k < n_clusters: slab test the
//              cluster box; on a hit, Moller-Trumbore over the cluster's
//              rows of the [T, 12] store (real-count guard on the last);
//              a hit records storage prim 128 k + j.
//   instanced  for each instance in index order: the world-box cull and the
//              w2o transform of the instanced tree walk, then the flat sweep
//              over the prototype's superclusters sup_base .. sup_base +
//              s_real - 1 (the REAL count, int slot 1), clusters cl_base + k
//              for k < n_clusters (slot 3) and store rows 128 (tile_base +
//              k) onward (slot 4; zero padding rows never hit); a hit records
//              the virtual prim prim_base + 128 k + j (slot 5).
// Every box test uses the ray's current best_t. The TPU kernels test a
// whole 512-ray tile against boxes with a best_t read at a supercluster's
// entry; those descent flags only prune, so the per-ray sweep is the same
// function. Closest hit, tie rule and any-hit exit as in ray_common.cuh.
//
// Design. One thread per ray; box rows are 32-byte __ldg loads, triangle
// rows 48-byte ones, all shared through L1/L2 by the warp. No shared
// memory: the tables of a prototype fit in L2.
//
// What bounds it on the H100. Operations: a ray tests every real
// supercluster box (ceil(T / 4096) of them per prototype entered), 32
// cluster boxes per supercluster hit and 128 triangles per cluster hit; its
// cost grows linearly with the scene where the tree walk's grows with the
// log. It is the fallback for tables without a tree, not the main route.
//
// Arithmetic. Built with --fmad=false and IEEE division, so each kernel
// equals its plain PyTorch version (ops/cluster_intersect.py) bit for bit.

#include "ray_common.cuh"

namespace {

using namespace akr;

// Sweep one supercluster -> cluster -> triangle hierarchy. Returns true
// when an any-hit query is done.
template <bool ANY_HIT>
__device__ __forceinline__ bool sweep(const Ray& r,
                                      const float4* __restrict__ supers,
                                      int n_supers,
                                      const float4* __restrict__ clusters,
                                      int n_clusters,
                                      const float4* __restrict__ tris,
                                      long long row0, int n_rows, int prim0,
                                      Best& best) {
  for (int s = 0; s < n_supers; ++s) {
    if (!slab_row(r, supers + 2 * (long long)s, best.t)) continue;
    for (int j = 0; j < SUPER; ++j) {
      const int k = s * SUPER + j;
      if (k >= n_clusters) break;
      if (!slab_row(r, clusters + 2 * (long long)k, best.t)) continue;
      const int first = k * TRI_TILE;
      if (tri_run<ANY_HIT>(r, tris, row0 + first,
                           min(TRI_TILE, n_rows - first), prim0 + first, best))
        return true;
    }
  }
  return false;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
cluster_kernel(const float* __restrict__ rays, long long n,
               const float4* __restrict__ supers,
               const float4* __restrict__ clusters,
               const float4* __restrict__ tris, int n_tris,
               float* __restrict__ t_out, float* __restrict__ u_out,
               float* __restrict__ v_out, int* __restrict__ prim_out,
               unsigned char* __restrict__ occ_out) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float tmax;
  const Ray r = load_ray(rays, n, i, &tmax);
  Best best = init_best<ANY_HIT>(tmax);
  const int n_cl = (n_tris + TRI_TILE - 1) / TRI_TILE;
  const int n_sup = (n_cl + SUPER - 1) / SUPER;
  sweep<ANY_HIT>(r, supers, n_sup, clusters, n_cl, tris, 0, n_tris, 0, best);
  store_best<ANY_HIT>(best, i, t_out, u_out, v_out, prim_out, occ_out);
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
instanced_cluster_kernel(const float* __restrict__ rays, long long n,
                         const float4* __restrict__ instf,
                         const int4* __restrict__ insti, int n_inst,
                         const float4* __restrict__ supers,
                         const float4* __restrict__ clusters,
                         const float4* __restrict__ tris,
                         float* __restrict__ t_out, float* __restrict__ u_out,
                         float* __restrict__ v_out, int* __restrict__ prim_out,
                         unsigned char* __restrict__ occ_out) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float tmax;
  const Ray w = load_ray(rays, n, i, &tmax);
  Best best = init_best<ANY_HIT>(tmax);
  for (int inst = 0; inst < n_inst; ++inst) {
    const InstanceRow row = load_instance(instf, inst);
    if (!slab(w, row.lo[0], row.lo[1], row.lo[2], row.hi[0], row.hi[1],
              row.hi[2], best.t))
      continue;
    const Ray r = to_object(w, row.m);
    const int4 ia = __ldg(insti + 2 * inst), ib = __ldg(insti + 2 * inst + 1);
    // (sup_base, s_real, cl_base, n_clusters), (tile_base, prim_base, ...);
    // the prototype's clusters are whole: n_rows = 128 n_clusters
    if (sweep<ANY_HIT>(r, supers + 2 * (long long)ia.x, ia.y,
                       clusters + 2 * (long long)ia.z, ia.w, tris,
                       (long long)ib.x * TRI_TILE, ia.w * TRI_TILE, ib.y,
                       best))
      break;
  }
  store_best<ANY_HIT>(best, i, t_out, u_out, v_out, prim_out, occ_out);
}

}  // namespace

extern "C" {

// Flat closest hit. rays: [8, n] f32 contiguous; supers [Spad, 8], clusters
// [Kpad, 8], tris [n_tris, 12] f32, all 16-byte aligned. Outputs [n].
// Returns the launch's cudaError_t.
int akr_cluster_closest(const float* rays, long long n, const float* supers,
                        const float* clusters, const float* tris, int n_tris,
                        float* t_out, float* u_out, float* v_out,
                        int* prim_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  cluster_kernel<false><<<launch_blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
      rays, n, (const float4*)supers, (const float4*)clusters,
      (const float4*)tris, n_tris, t_out, u_out, v_out, prim_out, nullptr);
  return (int)cudaGetLastError();
}

// Flat any hit; occ_out [n] bytes (0/1), written into a bool tensor.
int akr_cluster_anyhit(const float* rays, long long n, const float* supers,
                       const float* clusters, const float* tris, int n_tris,
                       unsigned char* occ_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  cluster_kernel<true><<<launch_blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
      rays, n, (const float4*)supers, (const float4*)clusters,
      (const float4*)tris, n_tris, nullptr, nullptr, nullptr, nullptr,
      occ_out);
  return (int)cudaGetLastError();
}

// Instanced closest hit. instf [n_inst, 20] f32, insti [n_inst, 8] i32,
// supers/clusters the concatenated per-prototype tables, tris [sum Kp*128,
// 12] f32.
int akr_instanced_cluster_closest(const float* rays, long long n,
                                  const float* instf, const int* insti,
                                  int n_inst, const float* supers,
                                  const float* clusters, const float* tris,
                                  float* t_out, float* u_out, float* v_out,
                                  int* prim_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  instanced_cluster_kernel<false><<<launch_blocks(n), BLOCK, 0,
                                    (cudaStream_t)stream>>>(
      rays, n, (const float4*)instf, (const int4*)insti, n_inst,
      (const float4*)supers, (const float4*)clusters, (const float4*)tris,
      t_out, u_out, v_out, prim_out, nullptr);
  return (int)cudaGetLastError();
}

// Instanced any hit; occ_out [n] bytes (0/1).
int akr_instanced_cluster_anyhit(const float* rays, long long n,
                                 const float* instf, const int* insti,
                                 int n_inst, const float* supers,
                                 const float* clusters, const float* tris,
                                 unsigned char* occ_out, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  instanced_cluster_kernel<true><<<launch_blocks(n), BLOCK, 0,
                                   (cudaStream_t)stream>>>(
      rays, n, (const float4*)instf, (const int4*)insti, n_inst,
      (const float4*)supers, (const float4*)clusters, (const float4*)tris,
      nullptr, nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
