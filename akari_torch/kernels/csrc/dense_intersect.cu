// Dense all-pairs Moller-Trumbore ray-triangle intersection for Hopper.
//
// Replaces the TPU kernel akari_tpu/ops/pallas_intersect.py: the launcher
// `_run` (pl.pallas_call) and its two bodies `_closest_kernel` (closest
// hit) and `_anyhit_kernel` (any hit), with helpers `_pairwise_mt_t`,
// `closest_update` and `init_state`.
//
// What it computes (the reference's semantics, exactly):
//   closest: for each ray, the triangle with the smallest t in
//     (t_min, best_t), best_t starting at min(t_max, T_MAX); |det| below
//     HIT_EPS never hits. Ties go to the lowest triangle index. A miss
//     gives prim -1, t = T_MAX, u = v = 0.
//   any-hit: 1 if any triangle hits in (t_min, t_max), else 0.
//
// Design. One thread per ray. The triangles are staged through shared
// memory in chunks of CHUNK rows (any triangle count works; the 36-triangle
// Cornell box takes 1.3 KB). Each thread loops over the triangles in
// ascending order with a strict `t < best_t`, which yields the
// reference's lowest-index tie order without a reduction. The any-hit
// variant stops at its first hit, and a block whose rays are all done
// skips the remaining chunks. Rays are the [8, N] rows of
// `_pack_rays_soa` (ox oy oz dx dy dz tmin tmax), read coalesced; there is
// no padding to a tile, the ragged tail is masked.
//
// Arithmetic. The operation order of `_pairwise_mt_t`, IEEE division for
// 1/det, built with --fmad=false and without --use_fast_math: the kernel
// then equals its plain PyTorch version (ops/dense_intersect.py) bit for
// bit on the card.
//
// What bounds it on the H100. Per ray and triangle about 40 float
// operations; the fused shadow+extension launch of a 256x256, 4 spp bounce
// is 524,288 rays x 36 triangles ~ 19 M tests (~0.8 GFLOP), and it moves
// 8 x 4 B in and 16 B (closest) out per ray, ~25 MB. At the card's
// ~50 TFLOP/s (no FMA) and 3.35 TB/s that is ~10-20 us of compute or
// traffic, below the launch latency and far below the surrounding eager
// elementwise ops of the path tracer: launches and host overhead bound the
// main path, not this kernel. For scenes with thousands of triangles the
// all-pairs sweep becomes compute-bound; those scenes take the BVH tree
// walk (slice 2).

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;        // threads (rays) per block
constexpr int CHUNK = 256;        // triangles per shared-memory chunk
constexpr int TRI_FLOATS = 9;     // v0.xyz e1.xyz e2.xyz
constexpr float HIT_EPS = 1e-9f;
constexpr float T_MAX = 1e30f;

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
dense_intersect_kernel(const float* __restrict__ rays, long long n,
                       const float* __restrict__ tris, int n_tris,
                       int tri_stride, float* __restrict__ t_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       int* __restrict__ prim_out,
                       unsigned char* __restrict__ occ_out) {
  __shared__ float s_tri[CHUNK * TRI_FLOATS];

  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tmax = 0.f;
  if (live) {
    ox = rays[i];
    oy = rays[n + i];
    oz = rays[2 * n + i];
    dx = rays[3 * n + i];
    dy = rays[4 * n + i];
    dz = rays[5 * n + i];
    tmin = rays[6 * n + i];
    tmax = rays[7 * n + i];
  }
  // init_state: best_t = minimum(t_max, T_MAX) (NaN stays NaN: never hits)
  float best_t = ANY_HIT ? tmax : (tmax > T_MAX ? T_MAX : tmax);
  float best_u = 0.f, best_v = 0.f;
  int best_prim = -1;
  bool done = !live;

  for (int base = 0; base < n_tris; base += CHUNK) {
    const int cnt = min(CHUNK, n_tris - base);
    // every thread reaches this barrier; the block leaves together once
    // all of its rays are done (any-hit) or masked
    if (__syncthreads_and(done)) break;
    for (int k = threadIdx.x; k < cnt * TRI_FLOATS; k += BLOCK) {
      const int row = k / TRI_FLOATS;
      const int col = k - row * TRI_FLOATS;
      s_tri[k] = tris[(long long)(base + row) * tri_stride + col];
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < cnt; ++j) {
        const float* tr = s_tri + j * TRI_FLOATS;
        const float v0x = tr[0], v0y = tr[1], v0z = tr[2];
        const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
        const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
        // pvec = d x e2
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float inv_det = 1.0f / (fabsf(det) < HIT_EPS ? 1.0f : det);
        const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        // qvec = tvec x e1
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool hit = (fabsf(det) >= HIT_EPS) && (u >= 0.f) &&
                         (v >= 0.f) && (u + v <= 1.f) && (t > tmin) &&
                         (t < best_t);
        if (hit) {
          if (ANY_HIT) {
            done = true;
            break;
          }
          best_t = t;
          best_u = u;
          best_v = v;
          best_prim = base + j;
        }
      }
    }
  }
  if (!live) return;
  if (ANY_HIT) {
    occ_out[i] = done ? 1 : 0;
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

// Closest hit. rays: [8, n] f32 contiguous; tris: [n_tris, tri_stride] f32
// rows whose first nine floats are v0, e1, e2. Outputs [n]. Returns the
// cudaError_t of the launch (0 on success).
int akr_dense_closest(const float* rays, long long n, const float* tris,
                      int n_tris, int tri_stride, float* t_out, float* u_out,
                      float* v_out, int* prim_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  dense_intersect_kernel<false><<<launch_blocks(n), BLOCK, 0,
                                  (cudaStream_t)stream>>>(
      rays, n, tris, n_tris, tri_stride, t_out, u_out, v_out, prim_out,
      nullptr);
  return (int)cudaGetLastError();
}

// Any hit. Same inputs; occ_out [n] bytes (0/1), written into a bool tensor.
int akr_dense_anyhit(const float* rays, long long n, const float* tris,
                     int n_tris, int tri_stride, unsigned char* occ_out,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  dense_intersect_kernel<true><<<launch_blocks(n), BLOCK, 0,
                                 (cudaStream_t)stream>>>(
      rays, n, tris, n_tris, tri_stride, nullptr, nullptr, nullptr, nullptr,
      occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
