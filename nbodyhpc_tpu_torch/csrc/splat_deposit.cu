// Deposit kernel (B2) of the splat tile engine: evaluates every particle's
// footprint inside its F^3 window and adds it straight into the logical
// (gx, gy, gz) float32 volume (C order, z fastest).
//
// Replaces nbodyhpc_tpu/ops/splat_pallas.py::_deposit_kernel. The TPU kernel
// lane-packed particles through a VMEM tile accumulator and flushed it to
// tile-major buffers that a separate XLA pass folded into the volume; here
// there is no tile buffer and no fold: contributions are atomic adds into the
// volume, and voxels outside [0, g) are dropped, as the fold's crop dropped
// them.
//
// Bound: device-memory bytes. The least work a launch must do is to read the
// chunk attributes once (28 bytes a row) and read-modify-write each voxel it
// changes once (8 bytes). The arithmetic is compare-and-count with
// data-dependent control flow (no tensor-core shape), so the design spends
// instructions only where the oracle's answer is not known in advance:
//
// 1. Covered box, not the window. Per particle, H = ceil(plane_r) + 1 at the
//    slice nearest its center (vz = floor(pz), the smallest |z_off|) is the
//    widest coverage square of any slice, and the voxels whose centers lie in
//    [p - H, p + H) form one interval per axis (the gate is monotone in the
//    voxel index). That x/y interval, cut to the window and the grid, is the
//    particle's box of (x, y) columns. Along a column the z-cull and the
//    square gate both hold on {|z_off| <= t}, an interval of slices that
//    contains floor(pz) whenever it is not empty; the thread walks out from
//    there (clamped to window and grid) and stops at the first slice the
//    gates reject. So no slot outside the covered box is visited, and every
//    visited voxel is decided by the oracle's own gate expressions.
// 2. Work list. One block per CH-row chunk (a chunk belongs to one tile, so a
//    block's atomics stay in one 128 x YTILE x 64 region and mostly hit L2).
//    Each particle contributes one item per column of its box (a sub-pixel
//    particle one item, its voxel); a block-wide prefix sum over the items
//    lets the 256 threads stride over a flat item index, so G32's 7-15 px
//    radii spread evenly. Consecutive items are neighbouring y columns of one
//    particle, so the lanes of a warp share its attributes and have similar
//    z extents.
// 3. Interior and exterior voxels without the S^3 loop: the per-voxel
//    subcell count of splat_common.h, which bounds each column's rab(a, b)
//    once and counts only the shell voxels.
// 4. Float4 atomics. A thread owns aligned groups of 4 z-voxels of its
//    column and adds each group with one atomicAdd(float4 *, float4)
//    (red.global.add.v4.f32, compute capability 9.x); voxels of the group
//    outside the footprint add exactly 0.0f. A group is only formed inside
//    the grid's (x, y) extent; when gz % 4 != 0, the volume is not 16-byte
//    aligned, or the group crosses the grid's z edge, the non-zero voxels go
//    through scalar atomicAdd. No address outside the grid is touched.
//
// Exactness: every expression is the oracle's (nbodyhpc_tpu_torch/ops/
// splat.py::footprint_terms) in the same float32 order; the window base is
// recomputed here from the materialized pixel-unit positions with the same
// ceil(p - (F/2 + 0.5)) as the tile keys. Build with --fmad=false (see
// splat_common.h). F and the common S = 4 are template parameters; other S
// up to 16 take the runtime path.
//
// Attribute layout: float32 [7][stride] rows px py pz rpx w_norm w_raw is_sub
// (the aligned stream of the align kernel); rows of chunk c are
// [c * ch, (c + 1) * ch).
#include <cuda_runtime.h>

#include <cstdint>

#include "splat_common.h"

namespace {

using splat::gated;
using splat::kMaxS;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAttrs = 7;  // px py pz rpx w_norm w_raw is_sub

// Voxel v's center offset (v + 0.5) - p along one axis lies in [-h, h).
__device__ __forceinline__ bool in_square(int v, float p, float h) {
  const float c = (static_cast<float>(v) + 0.5f) - p;
  return c >= -h && c < h;
}

// [lo, hi]: the voxels v in [a, b] with in_square(v, p, h) (empty when
// lo > hi). The set is an interval (c grows with v), [floor(p - h) - 1,
// ceil(p + h) + 1] holds it, and the ends are trimmed by the exact test.
__device__ __forceinline__ void square_range(float p, float h, int a, int b,
                                             int& lo, int& hi) {
  lo = max(static_cast<int>(floorf(p - h)) - 1, a);
  hi = min(static_cast<int>(ceilf(p + h)) + 1, b);
  while (lo <= hi && !in_square(lo, p, h)) ++lo;
  while (hi >= lo && !in_square(hi, p, h)) --hi;
}

// Block-wide exclusive prefix sum of v; *total receives the sum over all
// threads. Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

template <int F, int SC>  // SC = compile-time subsample, 0 = runtime s_rt
__global__ void __launch_bounds__(kThreads)
deposit_kernel(const float* __restrict__ attrs, long long stride, int ch,
               int s_rt, float* __restrict__ vol, int gx, int gy, int gz,
               bool vec4) {
  extern __shared__ float sm[];  // [kAttrs][ch] floats, then 4 x [ch] ints
  int* s_start = reinterpret_cast<int*>(sm + kAttrs * ch);
  int* s_x0 = s_start + ch;
  int* s_y0 = s_x0 + ch;
  int* s_ny = s_y0 + ch;
  __shared__ int warp_sums[kWarps];

  constexpr int kS = splat::kSlots<SC>;
  constexpr float kBase = F * 0.5f + 0.5f;  // exact for every bucket F
  const int S = SC > 0 ? SC : s_rt;
  const long long c0 = static_cast<long long>(blockIdx.x) * ch;
  for (int k = 0; k < kAttrs; ++k)
    for (int i = threadIdx.x; i < ch; i += kThreads)
      sm[k * ch + i] = attrs[k * stride + c0 + i];
  __syncthreads();

  // ---- per-particle boxes and the block's work list ----------------------
  const int per = (ch + kThreads - 1) / kThreads;
  const int i0 = min(static_cast<int>(threadIdx.x) * per, ch);
  const int i1 = min(i0 + per, ch);
  int mine = 0;
  for (int i = i0; i < i1; ++i) {
    const float px = sm[i], py = sm[ch + i], pz = sm[2 * ch + i];
    const int bx = static_cast<int>(ceilf(px - kBase));
    const int by = static_cast<int>(ceilf(py - kBase));
    const int bz = static_cast<int>(ceilf(pz - kBase));
    int n = 0, x0 = 0, y0 = 0, ny = 1;
    if (sm[4 * ch + i] == 0.0f && sm[5 * ch + i] == 0.0f) {
      // pad or zero weight: no items
    } else if (sm[6 * ch + i] > 0.5f) {
      // sub-pixel: the voxel containing it, z in (vz, vz + 1]
      const int vx = static_cast<int>(floorf(px));
      const int vy = static_cast<int>(floorf(py));
      const int vz = static_cast<int>(ceilf(pz)) - 1;
      const float vzf = static_cast<float>(vz);
      if (vx >= max(bx, 0) && vx < min(bx + F, gx) && vy >= max(by, 0) &&
          vy < min(by + F, gy) && vz >= max(bz, 0) && vz < min(bz + F, gz) &&
          pz > vzf && pz <= vzf + 1.0f) {
        n = 1;
        x0 = vx;
        y0 = vy;
      }
    } else {
      const float r = sm[3 * ch + i];
      const float r2 = r * r;
      const float zc = pz - (floorf(pz) + 0.5f);
      const float h = ceilf(sqrtf(fmaxf(r2 - zc * zc, 0.0f))) + 1.0f;
      int xl, xh, yl, yh;
      square_range(px, h, max(bx, 0), min(bx + F, gx) - 1, xl, xh);
      square_range(py, h, max(by, 0), min(by + F, gy) - 1, yl, yh);
      if (xl <= xh && yl <= yh) {
        ny = yh - yl + 1;
        n = (xh - xl + 1) * ny;
        x0 = xl;
        y0 = yl;
      }
    }
    s_start[i] = n;  // count for now; offsets below
    s_x0[i] = x0;
    s_y0[i] = y0;
    s_ny[i] = ny;
    mine += n;
  }
  int total;
  int off = block_exclusive_scan(mine, warp_sums, &total);
  for (int i = i0; i < i1; ++i) {
    const int n = s_start[i];
    s_start[i] = off;
    off += n;
  }
  __syncthreads();

  // ---- the items: one (particle, column) each ----------------------------
  const float s3 = static_cast<float>(S * S * S);
  float u[kS];
  splat::subcell_offsets<SC>(u, S);

  for (int it = threadIdx.x; it < total; it += kThreads) {
    // the particle: the last row whose item range starts at or before it
    int p = 0;
    for (int hi = ch - 1; p < hi;) {
      const int mid = (p + hi + 1) >> 1;
      if (s_start[mid] <= it) p = mid; else hi = mid - 1;
    }
    const int local = it - s_start[p];
    const int ny = s_ny[p];
    const int ix = local / ny;
    const int vx = s_x0[p] + ix;
    const int vy = s_y0[p] + (local - ix * ny);
    float* col = vol + (static_cast<long long>(vx) * gy + vy) * gz;
    const float px = sm[p], py = sm[ch + p], pz = sm[2 * ch + p];
    if (sm[6 * ch + p] > 0.5f) {
      atomicAdd(col + (static_cast<int>(ceilf(pz)) - 1), sm[5 * ch + p]);
      continue;
    }
    const float r = sm[3 * ch + p];
    const float w_norm = sm[4 * ch + p];
    const float r2 = r * r;
    const float vxf = static_cast<float>(vx);
    const float vyf = static_cast<float>(vy);
    const float cx = (vxf + 0.5f) - px;
    const float cy = (vyf + 0.5f) - py;

    // the column's gated slices: an interval around floor(pz)
    const int bz = static_cast<int>(ceilf(pz - kBase));
    const int za = max(bz, 0);
    const int zb = min(bz + F, gz) - 1;
    const int zs = min(max(static_cast<int>(floorf(pz)), za), zb);
    if (za > zb || !gated(cx, cy, pz, r, r2, zs)) continue;
    int zlo = zs, zhi = zs;
    while (zhi < zb && gated(cx, cy, pz, r, r2, zhi + 1)) ++zhi;
    while (zlo > za && gated(cx, cy, pz, r, r2, zlo - 1)) --zlo;

    // the column's subcell rows: rab(a, b) = r2 - (ax[a] + ay[b])
    float ax[kS], ay[kS], rab_lo, rab_hi;
    splat::column_rows<SC>(u, S, px - vxf, py - vyf, r2, ax, ay, rab_lo,
                           rab_hi);

    for (int g = zlo & ~3; g <= zhi; g += 4) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int vz = g + j;
        v[j] = 0.0f;
        if (vz < zlo || vz > zhi) continue;
        const int count = splat::subcell_count<SC>(
            u, S, ax, ay, r2, rab_lo, rab_hi, pz - static_cast<float>(vz));
        if (count == 0) continue;
        v[j] = w_norm * (static_cast<float>(count) / s3);
      }
      if (v[0] == 0.0f && v[1] == 0.0f && v[2] == 0.0f && v[3] == 0.0f)
        continue;
      if (vec4 && g + 3 < gz) {
        atomicAdd(reinterpret_cast<float4*>(col + g),
                  make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (v[j] != 0.0f) atomicAdd(col + g + j, v[j]);
      }
    }
  }
}

template <int F>
int launch(const float* attrs, long long stride, int nchunks, int ch, int S,
           float* vol, int gx, int gy, int gz, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kAttrs + 4) * ch;
  const bool vec4 =
      gz % 4 == 0 && reinterpret_cast<std::uintptr_t>(vol) % 16 == 0;
  if (S == 4)
    deposit_kernel<F, 4><<<nchunks, kThreads, smem, stream>>>(
        attrs, stride, ch, S, vol, gx, gy, gz, vec4);
  else
    deposit_kernel<F, 0><<<nchunks, kThreads, smem, stream>>>(
        attrs, stride, ch, S, vol, gx, gy, gz, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int splat_deposit(const float* attrs, long long stride, int nchunks,
                             int ch, int F, int S, float* vol, int gx, int gy,
                             int gz, cudaStream_t stream) {
  if (nchunks <= 0 || ch <= 0 || S < 1 || S > kMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (F) {
    case 6: return launch<6>(attrs, stride, nchunks, ch, S, vol, gx, gy, gz, stream);
    case 8: return launch<8>(attrs, stride, nchunks, ch, S, vol, gx, gy, gz, stream);
    case 10: return launch<10>(attrs, stride, nchunks, ch, S, vol, gx, gy, gz, stream);
    case 12: return launch<12>(attrs, stride, nchunks, ch, S, vol, gx, gy, gz, stream);
    case 16: return launch<16>(attrs, stride, nchunks, ch, S, vol, gx, gy, gz, stream);
    case 32: return launch<32>(attrs, stride, nchunks, ch, S, vol, gx, gy, gz, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
