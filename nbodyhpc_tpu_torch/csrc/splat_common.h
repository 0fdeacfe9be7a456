// Shared device code of the splat kernels (splat_deposit.cu, splat_dense.cu):
// the oracle's gates at one voxel and the voxel's subcell count.
//
// The subcell count of voxel (vx, vy, vz) for a particle at p with pixel
// radius r is sum over (a, b, c) of [az[c] < rab(a, b)], with u[a] = (a +
// 0.5) / S, ax[a] = (px - vx - u[a])^2 (ay, az likewise) and rab(a, b) = r2 -
// (ax[a] + ay[b]), every term the oracle's float32 expression
// (nbodyhpc_tpu_torch/ops/splat.py::footprint_terms) in the same order.
// Rounded addition and subtraction are monotone in each operand, so for
// every (a, b)
//   rab_lo = r2 - (max ax + max ay)  <=  rab(a, b)  <=  r2 - (min ax +
//   min ay) = rab_hi.
// If max az < rab_lo every compare is true (count S^3); if min az >= rab_hi
// every compare is false (count 0). Only the remaining shell voxels are
// counted: the S values of az are sorted once and each (a, b) row adds the
// number of sorted values below rab(a, b), found by a branch-free
// lower-bound search. That search makes the same az[c] < rab compares, so on
// a multiset of the same values it returns exactly the loop's count. Build
// with --fmad=false: a contracted r2 - (ax + ay) could flip a knife-edge
// subcell.
//
// SC is the subsample factor when it is a compile-time constant (the common
// S = 4, whose loops unroll and whose sort is a network), 0 for the runtime
// path, which takes any S up to kMaxS.
#pragma once

#include <cuda_runtime.h>

namespace splat {

constexpr int kMaxS = 16;  // largest subsample factor the kernels take

// The length of a kernel's per-axis subcell arrays, and how far their loops
// unroll (only fixed-S loops do).
template <int SC>
constexpr int kSlots = SC > 0 ? SC : kMaxS;
template <int SC>
constexpr int kUnrollS = SC > 0 ? SC : 1;

// The oracle's gates at slice vz for a column with center offsets (cx, cy):
// the gl_ClipDistance z-cull |z_off| <= r + 1, then the coverage square of
// half-side ceil(plane_r) + 1.
__device__ __forceinline__ bool gated(float cx, float cy, float pz, float r,
                                      float r2, int vz) {
  const float zoff = pz - (static_cast<float>(vz) + 0.5f);
  if (!(fabsf(zoff) <= r + 1.0f)) return false;
  const float half = ceilf(sqrtf(fmaxf(r2 - zoff * zoff, 0.0f))) + 1.0f;
  return cx >= -half && cx < half && cy >= -half && cy < half;
}

// Number of the S sorted values s[0..S) below x (a lower-bound search).
template <int SC>
__device__ __forceinline__ int count_below(const float* s, float x, int S) {
  if constexpr (SC == 4) {
    const bool b1 = s[1] < x;
    const bool b2 = (b1 ? s[2] : s[0]) < x;
    return 2 * b1 + b2 + (b1 && b2 && s[3] < x);
  } else {
    int base = 0;
    for (int n = S; n > 1;) {
      const int h = n >> 1;
      base = s[base + h] < x ? base + h : base;
      n -= h;
    }
    return base + (s[base] < x);
  }
}

__device__ __forceinline__ void cswap(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// Sorts s[0..S) ascending (a network for S = 4, insertion otherwise).
template <int SC>
__device__ __forceinline__ void sort_values(float* s, int S) {
  if constexpr (SC == 4) {
    cswap(s[0], s[1]);
    cswap(s[2], s[3]);
    cswap(s[0], s[2]);
    cswap(s[1], s[3]);
    cswap(s[1], s[2]);
  } else {
    for (int i = 1; i < S; ++i) {
      const float v = s[i];
      int j = i;
      for (; j > 0 && s[j - 1] > v; --j) s[j] = s[j - 1];
      s[j] = v;
    }
  }
}

// u[a] = (a + 0.5) / S, the subcell centres' offsets inside a voxel.
template <int SC>
__device__ __forceinline__ void subcell_offsets(float (&u)[kSlots<SC>],
                                                int S) {
  constexpr int kUnroll = kUnrollS<SC>;
#pragma unroll kUnroll
  for (int a = 0; a < kSlots<SC>; ++a)
    u[a] = (static_cast<float>(a) + 0.5f) / static_cast<float>(S);
}

// A column's subcell rows: ax, ay from the particle's offsets dx = px - vx,
// dy = py - vy, and the bounds rab_lo <= rab(a, b) <= rab_hi.
template <int SC>
__device__ __forceinline__ void column_rows(const float (&u)[kSlots<SC>],
                                            int S, float dx, float dy,
                                            float r2, float (&ax)[kSlots<SC>],
                                            float (&ay)[kSlots<SC>],
                                            float& rab_lo, float& rab_hi) {
  constexpr int kUnroll = kUnrollS<SC>;
  float axmin = __int_as_float(0x7f800000), axmax = 0.0f;
  float aymin = axmin, aymax = 0.0f;
#pragma unroll kUnroll
  for (int a = 0; a < kSlots<SC>; ++a) {
    if (a >= S) break;
    float t = dx - u[a];
    ax[a] = t * t;
    t = dy - u[a];
    ay[a] = t * t;
    axmin = fminf(axmin, ax[a]);
    axmax = fmaxf(axmax, ax[a]);
    aymin = fminf(aymin, ay[a]);
    aymax = fmaxf(aymax, ay[a]);
  }
  rab_lo = r2 - (axmax + aymax);
  rab_hi = r2 - (axmin + aymin);
}

// The subcell count (0..S^3) of the column's voxel at dz = pz - vz.
template <int SC>
__device__ __forceinline__ int subcell_count(const float (&u)[kSlots<SC>],
                                             int S,
                                             const float (&ax)[kSlots<SC>],
                                             const float (&ay)[kSlots<SC>],
                                             float r2, float rab_lo,
                                             float rab_hi, float dz) {
  constexpr int kUnroll = kUnrollS<SC>;
  float az[kSlots<SC>];
  float azmin = __int_as_float(0x7f800000), azmax = 0.0f;
#pragma unroll kUnroll
  for (int c = 0; c < kSlots<SC>; ++c) {
    if (c >= S) break;
    const float t = dz - u[c];
    az[c] = t * t;
    azmin = fminf(azmin, az[c]);
    azmax = fmaxf(azmax, az[c]);
  }
  if (azmax < rab_lo) return S * S * S;  // interior: every compare holds
  if (azmin >= rab_hi) return 0;         // exterior: no compare holds
  sort_values<SC>(az, S);
  int count = 0;
#pragma unroll kUnroll
  for (int a = 0; a < kSlots<SC>; ++a) {
    if (a >= S) break;
#pragma unroll kUnroll
    for (int b = 0; b < kSlots<SC>; ++b) {
      if (b >= S) break;
      count += count_below<SC>(az, r2 - (ax[a] + ay[b]), S);
    }
  }
  return count;
}

// subcell_count's interior test (max az < rab_lo) at dz = pz - vz, from the
// first and last subcell offsets ulo = u[0], uhi = u[S - 1]: the rounded
// differences dz - u[c] fall as u[c] grows, so the largest of their squares
// is the first's or the last's, and the test is exactly subcell_count's.
__device__ __forceinline__ bool interior(float ulo, float uhi, float rab_lo,
                                         float dz) {
  const float a = dz - ulo, b = dz - uhi;
  return fmaxf(a * a, b * b) < rab_lo;
}

}  // namespace splat
