// Align kernel (B1) of the splat tile engine: ragged per-tile runs of the
// tile-sorted particle stream -> a CH-aligned stream in which every CH-row
// chunk belongs to exactly one tile.
//
// Replaces nbodyhpc_tpu/ops/splat_pallas.py::_align_kernel. On the TPU the
// copy went through VMEM in 2048-row DMA pieces from a 128-aligned floor with
// a lane roll; on Hopper it is a plain strided copy.
//
// Bound: device-memory bandwidth. Each row moves 7 x 4 bytes in and out;
// neighbouring threads handle neighbouring rows, so every channel's loads and
// stores are coalesced. One block per tile runs its tile's rows plus the
// zero pad rows that fill the tile's last chunk; tiles are independent, so
// the blocks need no ordering.
//
// Layout (structure of arrays, row-major [channel][row]):
//   srcf/dstf  float32 [7][*]: px py pz rpx w_norm w_raw is_sub
// Pad rows are 0 in every channel: zero weights, which deposit nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kNF = 7;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
align_kernel(const int* __restrict__ starts, const int* __restrict__ cnts,
             const int* __restrict__ aoff, const float* __restrict__ srcf,
             float* __restrict__ dstf, long long src_stride,
             long long dst_stride, int ch) {
  const int t = blockIdx.x;
  const long long s = starts[t];
  const int c = cnts[t];
  const long long a = aoff[t];
  const int n = (c + ch - 1) / ch * ch;  // rows up to the CH multiple
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long d = a + i;
#pragma unroll
    for (int k = 0; k < kNF; ++k)
      dstf[k * dst_stride + d] = i < c ? srcf[k * src_stride + s + i] : 0.0f;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int splat_align(const int* starts, const int* cnts, const int* aoff,
                           const float* srcf, float* dstf, int ntiles,
                           long long src_stride, long long dst_stride, int ch,
                           cudaStream_t stream) {
  if (ntiles <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  align_kernel<<<ntiles, kThreads, 0, stream>>>(
      starts, cnts, aoff, srcf, dstf, src_stride, dst_stride, ch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nbodyhpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
