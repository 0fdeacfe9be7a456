// Align kernel (B1) of the splat tile engine: ragged per-tile runs of the
// tile-sorted particle stream -> a CH-aligned stream in which every CH-row
// chunk belongs to exactly one tile.
//
// Replaces nbodyhpc_tpu/ops/splat_pallas.py::_align_kernel. On the TPU the
// copy went through VMEM in 2048-row DMA pieces from a 128-aligned floor with
// a lane roll; on Hopper it is a plain strided copy.
//
// Bound: device-memory bandwidth. Each row moves 12 x 4 bytes in and out;
// neighbouring threads handle neighbouring rows, so every channel's loads and
// stores are coalesced. One block per tile runs its tile's rows plus the
// inert pad rows that fill the tile's last chunk; tiles are independent, so
// the blocks need no ordering.
//
// Layout (structure of arrays, row-major [channel][row]):
//   srcf/dstf  float32 [8][*]: px py pz rpx w_norm w_raw is_sub spare
//   srci/dsti  int32   [4][*]: tile bx_ext bz_ext by_local
// Pad rows: float channels 0, int channels (tile = t, halo, halo, 0) -- the
// same inert rows the TPU kernel writes.
#include <cuda_runtime.h>

namespace {

constexpr int kNF = 8;
constexpr int kNI = 4;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
align_kernel(const int* __restrict__ starts, const int* __restrict__ cnts,
             const int* __restrict__ aoff, const float* __restrict__ srcf,
             const int* __restrict__ srci, float* __restrict__ dstf,
             int* __restrict__ dsti, long long src_stride,
             long long dst_stride, int ch, int halo) {
  const int t = blockIdx.x;
  const long long s = starts[t];
  const int c = cnts[t];
  const long long a = aoff[t];
  const int n = (c + ch - 1) / ch * ch;  // rows up to the CH multiple
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long d = a + i;
    if (i < c) {
#pragma unroll
      for (int k = 0; k < kNF; ++k)
        dstf[k * dst_stride + d] = srcf[k * src_stride + s + i];
#pragma unroll
      for (int k = 0; k < kNI; ++k)
        dsti[k * dst_stride + d] = srci[k * src_stride + s + i];
    } else {
#pragma unroll
      for (int k = 0; k < kNF; ++k) dstf[k * dst_stride + d] = 0.0f;
      dsti[d] = t;
      dsti[dst_stride + d] = halo;
      dsti[2 * dst_stride + d] = halo;
      dsti[3 * dst_stride + d] = 0;
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int splat_align(const int* starts, const int* cnts, const int* aoff,
                           const float* srcf, const int* srci, float* dstf,
                           int* dsti, int ntiles, long long src_stride,
                           long long dst_stride, int ch, int halo,
                           cudaStream_t stream) {
  if (ntiles <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  align_kernel<<<ntiles, kThreads, 0, stream>>>(
      starts, cnts, aoff, srcf, srci, dstf, dsti, src_stride, dst_stride, ch,
      halo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nbodyhpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
