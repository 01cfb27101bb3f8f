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
// Arithmetic. The operation order of `_pairwise_mt_t`, IEEE division for
// 1/det, built with --fmad=false and without --use_fast_math: the kernel
// then equals its plain PyTorch version (ops/dense_intersect.py) bit for
// bit on the card.
//
// What bounds it on the H100: instruction issue. A test is 46 float
// multiplies and adds (no FMA under the bit-exact contract), an IEEE
// reciprocal with its range check (~10 instructions), the compares and
// selects of the hit expression, its share of the triangle's loads and of
// the loop: ~75 SASS instructions (tools/dense_kernel_ab.py counts them).
// The fused launch of a 256x256, 4 spp bounce (524,288 rays x 36
// triangles) moves ~25 MB (~7.5 us at 3.35 TB/s) but issues ~1.4 G
// lane-instructions (~43 us at 132 SMs x 4 schedulers x 32 lanes x
// ~1.98 GHz). So the design cuts instructions per test and tests:
//
// 1. Dead rays take no test. A ray with !(t_min < best_t), NaN included,
//    can never hit (the reference's hit needs t > t_min and t < best_t):
//    it is done at entry and writes the miss; a warp whose rays are all
//    done skips the triangle loop, and a block whose rays are all done
//    skips every chunk. (The fused launch's dead rays, paths that ended,
//    come in runs: 646 of the 8,192 warps of a Cornell frame's first fused
//    launch hold no live ray.)
// 2. One triangle load serves several rays. Each thread carries RAYS rays
//    (rays first + k * BLOCK + tid, coalesced). The triangles are staged
//    through shared memory in chunks of CHUNK as three 16-byte vectors,
//    (v0.xyz, e1.x) (e1.yz, e2.xy) (e2.z, pad): two LDS.128 and one LDS.32
//    a triangle, broadcast to the warp, feed RAYS independent tests (rows of
//    9 floats are not 16-byte aligned and would take nine scalar loads),
//    and the triangle loop is unrolled by 2.
// 3. Each ray visits the triangles in ascending order with a strict
//    `t < best_t`, which yields the lowest-index tie order without a
//    reduction. The any-hit variant ends a ray at its first hit and a
//    warp when all its rays are done.
//
// An exact staged rejection before the division (a warp vote after det and
// u_num, and after v_num, skipping the rest of a pair that every lane
// rejects) was measured and left out: a warp rejects a triangle together
// too rarely on the main path's rays to pay for the predicate and votes
// (PERF.md, ROADMAP.md Queue 3).
//
// Rays are the [8, N] rows of `_pack_rays_soa` (ox oy oz dx dy dz tmin
// tmax); there is no padding to a tile, the ragged tail is masked.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;        // threads per block
constexpr int RAYS = 2;           // rays per thread
constexpr int BLOCK_RAYS = BLOCK * RAYS;
constexpr int CHUNK = 256;        // triangles per shared-memory chunk
constexpr int TRI_FLOATS = 9;     // v0.xyz e1.xyz e2.xyz
constexpr int TRI_VEC = 3;        // 16-byte vectors a staged triangle
constexpr unsigned FULL_MASK = 0xffffffffu;
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
  __shared__ float4 s_tri[CHUNK * TRI_VEC];

  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * BLOCK_RAYS;
  float ox[RAYS], oy[RAYS], oz[RAYS], dx[RAYS], dy[RAYS], dz[RAYS];
  float tmin[RAYS], best_t[RAYS], best_u[RAYS], best_v[RAYS];
  int best_prim[RAYS];
  bool done[RAYS], occluded[RAYS];
  bool finished = true;  // all of this thread's rays are done
#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    const long long i = first + k * BLOCK + tid;
    ox[k] = oy[k] = oz[k] = dx[k] = dy[k] = dz[k] = 0.f;
    tmin[k] = best_t[k] = 0.f;
    bool live = false;
    if (i < n) {
      ox[k] = rays[i];
      oy[k] = rays[n + i];
      oz[k] = rays[2 * n + i];
      dx[k] = rays[3 * n + i];
      dy[k] = rays[4 * n + i];
      dz[k] = rays[5 * n + i];
      tmin[k] = rays[6 * n + i];
      // init_state: best_t = minimum(t_max, T_MAX) (NaN stays NaN)
      const float tmax = rays[7 * n + i];
      best_t[k] = ANY_HIT ? tmax : (tmax > T_MAX ? T_MAX : tmax);
      live = tmin[k] < best_t[k];  // else no t lies in (t_min, best_t)
    }
    best_u[k] = 0.f;
    best_v[k] = 0.f;
    best_prim[k] = -1;
    occluded[k] = false;
    done[k] = !live;
    finished = finished && done[k];
  }

  float* s_flat = reinterpret_cast<float*>(s_tri);
  for (int base = 0; base < n_tris; base += CHUNK) {
    const int cnt = min(CHUNK, n_tris - base);
    // every thread reaches this barrier; the block leaves together once
    // all of its rays are done
    if (__syncthreads_and(finished)) break;
    for (int e = tid; e < cnt * TRI_FLOATS; e += BLOCK) {
      const int row = e / TRI_FLOATS;
      const int col = e - row * TRI_FLOATS;
      s_flat[row * 4 * TRI_VEC + col] =
          tris[(long long)(base + row) * tri_stride + col];
    }
    __syncthreads();
    if (__all_sync(FULL_MASK, finished)) continue;  // warp-uniform
#pragma unroll 2
    for (int j = 0; j < cnt; ++j) {
      const float4 a = s_tri[TRI_VEC * j];
      const float4 b = s_tri[TRI_VEC * j + 1];
      const float e2z = s_flat[4 * (TRI_VEC * j + 2)];
      const float v0x = a.x, v0y = a.y, v0z = a.z;
      const float e1x = a.w, e1y = b.x, e1z = b.y;
      const float e2x = b.z, e2y = b.w;
      // in three stages across the RAYS rays, so that their independent
      // chains interleave: faster than one ray's whole test after the
      // other (PERF.md)
      float det[RAYS], tx[RAYS], ty[RAYS], tz[RAYS], un[RAYS];
#pragma unroll
      for (int k = 0; k < RAYS; ++k) {
        // pvec = d x e2
        const float px = dy[k] * e2z - dz[k] * e2y;
        const float py = dz[k] * e2x - dx[k] * e2z;
        const float pz = dx[k] * e2y - dy[k] * e2x;
        det[k] = e1x * px + e1y * py + e1z * pz;
        tx[k] = ox[k] - v0x;
        ty[k] = oy[k] - v0y;
        tz[k] = oz[k] - v0z;
        un[k] = tx[k] * px + ty[k] * py + tz[k] * pz;
      }
      float qx[RAYS], qy[RAYS], qz[RAYS], vn[RAYS];
#pragma unroll
      for (int k = 0; k < RAYS; ++k) {
        // qvec = tvec x e1
        qx[k] = ty[k] * e1z - tz[k] * e1y;
        qy[k] = tz[k] * e1x - tx[k] * e1z;
        qz[k] = tx[k] * e1y - ty[k] * e1x;
        vn[k] = dx[k] * qx[k] + dy[k] * qy[k] + dz[k] * qz[k];
      }
#pragma unroll
      for (int k = 0; k < RAYS; ++k) {
        const float inv_det =
            1.0f / (fabsf(det[k]) < HIT_EPS ? 1.0f : det[k]);
        const float u = un[k] * inv_det;
        const float v = vn[k] * inv_det;
        const float t = (e2x * qx[k] + e2y * qy[k] + e2z * qz[k]) * inv_det;
        const bool hit = (fabsf(det[k]) >= HIT_EPS) && (u >= 0.f) &&
                         (v >= 0.f) && (u + v <= 1.f) && (t > tmin[k]) &&
                         (t < best_t[k]);
        if (hit) {
          if (ANY_HIT) {
            done[k] = true;
            occluded[k] = true;
          } else {
            best_t[k] = t;
            best_u[k] = u;
            best_v[k] = v;
            best_prim[k] = base + j;
          }
        }
      }
      if (ANY_HIT) {
        finished = true;
#pragma unroll
        for (int k = 0; k < RAYS; ++k) finished = finished && done[k];
        if (__all_sync(FULL_MASK, finished)) break;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    const long long i = first + k * BLOCK + tid;
    if (i >= n) continue;
    if (ANY_HIT) {
      occ_out[i] = occluded[k] ? 1 : 0;
    } else {
      const bool valid = best_prim[k] >= 0;
      t_out[i] = valid ? best_t[k] : T_MAX;
      u_out[i] = best_u[k];
      v_out[i] = best_v[k];
      prim_out[i] = best_prim[k];
    }
  }
}

int launch_blocks(long long n) {
  return (int)((n + BLOCK_RAYS - 1) / BLOCK_RAYS);
}

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
