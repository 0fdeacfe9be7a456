// Deposit kernel (B2) of the splat tile engine: evaluates every particle's
// F^3 footprint window and adds it straight into the logical (gx, gy, gz)
// float32 volume (C order, z fastest).
//
// Replaces nbodyhpc_tpu/ops/splat_pallas.py::_deposit_kernel. The TPU kernel
// lane-packed particles through a VMEM tile accumulator and flushed it to
// tile-major buffers that a separate XLA pass folded into the volume; here
// there is no tile buffer and no fold: each voxel contribution is one
// atomicAdd into the volume, and voxels outside [0, g) are dropped, as the
// fold's crop dropped them.
//
// Bound: arithmetic. A voxel of a big particle costs the S^3 subcell test
// (64 compares at S = 4) after two cheap gates (z-cull, coverage square),
// against one atomicAdd of 4 bytes when it is non-zero. The design: one block
// per CH-row chunk of the aligned stream -- a chunk belongs to one tile, so a
// block's atomics land in one 128 x YTILE x 64 region of the volume and mostly
// hit L2 -- with the chunk's attributes staged in shared memory and threads
// striding over (particle, window voxel) with z fastest, so a warp's atomics
// go to neighbouring addresses. F and the common S = 4 are template
// parameters, so the index divisions and the subcell loops compile to
// constants.
//
// Exactness: every expression is the oracle's (nbodyhpc_tpu_torch/ops/
// splat.py) in the same float32 order; the window base is recomputed here
// from the materialized pixel-unit positions with the same ceil(p - (F/2 +
// 0.5)) as the tile keys. Build with --fmad=false so no multiply-add is
// contracted: a contracted r2 - (ax + ay) could flip a knife-edge subcell.
//
// Attribute layout: float32 [8][stride] rows px py pz rpx w_norm w_raw is_sub
// spare (the aligned stream of the align kernel); rows of chunk c are
// [c * ch, (c + 1) * ch).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAttrs = 7;  // px py pz rpx w_norm w_raw is_sub
constexpr int kMaxS = 16;  // largest subsample factor the generic path takes

template <int F, int SC>  // SC = compile-time subsample, 0 = runtime s_rt
__global__ void __launch_bounds__(kThreads)
deposit_kernel(const float* __restrict__ attrs, long long stride, int ch,
               int s_rt, float* __restrict__ vol, int gx, int gy, int gz) {
  extern __shared__ float sm[];  // [kAttrs][ch]
  constexpr int kS = SC > 0 ? SC : kMaxS;
  constexpr int kUnroll = SC > 0 ? SC : 1;  // unroll only fixed-S loops
  const int S = SC > 0 ? SC : s_rt;
  const long long c0 = static_cast<long long>(blockIdx.x) * ch;
  for (int k = 0; k < kAttrs; ++k)
    for (int i = threadIdx.x; i < ch; i += kThreads)
      sm[k * ch + i] = attrs[k * stride + c0 + i];
  __syncthreads();

  constexpr int F2 = F * F;
  constexpr int F3 = F * F * F;
  constexpr float kBase = F * 0.5f + 0.5f;  // exact for every bucket F
  const float s3 = static_cast<float>(S * S * S);
  const int total = ch * F3;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int p = idx / F3;
    const int rem = idx - p * F3;
    const float w_norm = sm[4 * ch + p];
    const float w_raw = sm[5 * ch + p];
    if (w_norm == 0.0f && w_raw == 0.0f) continue;  // pad or zero weight
    const float px = sm[p];
    const float py = sm[ch + p];
    const float pz = sm[2 * ch + p];
    const int vx = static_cast<int>(ceilf(px - kBase)) + rem / F2;
    const int vy = static_cast<int>(ceilf(py - kBase)) + (rem / F) % F;
    const int vz = static_cast<int>(ceilf(pz - kBase)) + rem % F;
    if (vx < 0 || vx >= gx || vy < 0 || vy >= gy || vz < 0 || vz >= gz)
      continue;  // off-grid spill is discarded
    const float vxf = static_cast<float>(vx);
    const float vyf = static_cast<float>(vy);
    const float vzf = static_cast<float>(vz);

    float val;
    if (sm[6 * ch + p] > 0.5f) {
      // sub-pixel: full weight into the containing voxel, z in (vz, vz+1]
      if (!(vxf == floorf(px) && vyf == floorf(py) && pz > vzf &&
            pz <= vzf + 1.0f))
        continue;
      val = w_raw;
    } else {
      const float r = sm[3 * ch + p];
      const float zoff = pz - (vzf + 0.5f);
      if (!(fabsf(zoff) <= r + 1.0f)) continue;  // gl_ClipDistance cull
      const float r2 = r * r;
      const float plane_r = sqrtf(fmaxf(r2 - zoff * zoff, 0.0f));
      const float half = ceilf(plane_r) + 1.0f;
      const float cx = (vxf + 0.5f) - px;
      const float cy = (vyf + 0.5f) - py;
      if (!(cx >= -half && cx < half && cy >= -half && cy < half)) continue;
      float ax[kS], ay[kS], az[kS];
      const float dx = px - vxf;
      const float dy = py - vyf;
      const float dz = pz - vzf;
#pragma unroll kUnroll
      for (int a = 0; a < kS; ++a) {
        if (a >= S) break;
        const float u = (static_cast<float>(a) + 0.5f) / static_cast<float>(S);
        float t = dx - u;
        ax[a] = t * t;
        t = dy - u;
        ay[a] = t * t;
        t = dz - u;
        az[a] = t * t;
      }
      int count = 0;
#pragma unroll kUnroll
      for (int a = 0; a < kS; ++a) {
        if (a >= S) break;
#pragma unroll kUnroll
        for (int b = 0; b < kS; ++b) {
          if (b >= S) break;
          const float rab = r2 - (ax[a] + ay[b]);
#pragma unroll kUnroll
          for (int c = 0; c < kS; ++c) {
            if (c >= S) break;
            count += az[c] < rab;
          }
        }
      }
      if (count == 0) continue;
      val = w_norm * (static_cast<float>(count) / s3);
    }
    atomicAdd(vol + ((static_cast<long long>(vx) * gy + vy) * gz + vz), val);
  }
}

template <int F>
int launch(const float* attrs, long long stride, int nchunks, int ch, int S,
           float* vol, int gx, int gy, int gz, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kAttrs * ch;
  if (S == 4)
    deposit_kernel<F, 4><<<nchunks, kThreads, smem, stream>>>(
        attrs, stride, ch, S, vol, gx, gy, gz);
  else
    deposit_kernel<F, 0><<<nchunks, kThreads, smem, stream>>>(
        attrs, stride, ch, S, vol, gx, gy, gz);
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
