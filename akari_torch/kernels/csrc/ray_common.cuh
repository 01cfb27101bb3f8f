// Per-ray pieces shared by the port's traversal kernels (tree_intersect.cu,
// instanced_tree_intersect.cu, cluster_intersect.cu): the reference's slab
// test and Moller-Trumbore test in its operation order, and the closest-hit
// record with the lowest-index tie rule. One thread owns one ray.
//
// Built with --fmad=false and IEEE division (kernels/build.py), so every
// float operation is rounded as the plain PyTorch versions round it.

#pragma once

#include <cuda_runtime.h>

namespace akr {

constexpr int BLOCK = 128;         // threads (rays) per block
constexpr int STACK_DEPTH = 64;    // refs per ray (cluster_tree.STACK_DEPTH)
constexpr int TRI_TILE = 128;      // triangles per cluster
constexpr int SUPER = 32;          // clusters per supercluster
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

// Moller-Trumbore over `count` rows of a [*, 12] triangle store (v0 e1 e2
// pad: three 16-byte loads a row) from row `first`; row first + j is prim
// prim0 + j. The operation order of `_pairwise_mt_t`
// (pallas_intersect.py:56-90). Returns true when an any-hit query is done.
template <bool ANY_HIT>
__device__ __forceinline__ bool tri_run(const Ray& r,
                                        const float4* __restrict__ tris,
                                        long long first, int count, int prim0,
                                        Best& b) {
  for (int j = 0; j < count; ++j) {
    const float4* tr = tris + 3 * (first + j);
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
      if (ok && t < b.t) {
        b.occluded = true;
        return true;
      }
    } else {
      const int p = prim0 + j;
      if (ok && (t < b.t || (t == b.t && p < b.prim))) {
        b.t = t;
        b.u = u;
        b.v = v;
        b.prim = p;
      }
    }
  }
  return false;
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
