// Candidate top-k kernel (B3) of the k-NN engine: for every query of a piece,
// the squared distances to all of the piece's candidates and their exact
// k smallest, ascending, ties to the first candidate in run-then-slot order.
//
// Replaces nbodyhpc_tpu/ops/knn_pallas.py::_knn_topk_kernel. The TPU kernel
// DMA'd runs from 128-aligned floors into VMEM, rolled them to lane 0, packed
// up to 12 pieces into a 128-row block with a [128, NCAND] distance scratch,
// and extracted the top-k by kpad full-width min passes (or a two-level
// shortlist with an overflow flag). None of that carries over: here each
// thread owns one query and keeps its top-K (K = next power of two >= k, at
// most 128) sorted in registers, inserting with a strict compare. The first
// candidate seen wins a tie, and candidates are visited in run order then
// slot order -- lax.top_k's lowest-slot rule. The selection is exact, so
// there is no overflow flag and no shortlist.
//
// Bound: arithmetic and issue, not memory. A piece's candidates (one FULLZ
// column's 3x3 neighbour columns: ~7.7k points at 1e7 uniform points) are
// read once per block through shared memory in coalesced kTile-point tiles
// and reused by up to kQB queries, so device-memory traffic is ~12 bytes per
// candidate per piece; the work is ~15 instructions per (query, candidate)
// pair. What limits the design is lane occupancy: a piece averages ~43
// queries at the full-size shape, so about a third of the lanes idle.
// Candidate splitting across threads (or warp-level merges) is later work.
//
// Output: d2 [nrows][k] float32 and the tree slot [nrows][k] int32 directly
// (row = piece_q0[p] - row_base + thread); unfilled entries are inf / -1.
#include <cuda_runtime.h>

#include "knn_common.h"

namespace {

using knn::Box;
using knn::kQB;
using knn::Runs;

constexpr int kTile = 256;  // candidates staged per tile

template <int K, bool PERIODIC>
__global__ void __launch_bounds__(kQB)
knn_topk_kernel(const float* __restrict__ q, long long qstride,
                const int* __restrict__ piece_q0,
                const int* __restrict__ piece_qn,
                const int* __restrict__ piece_pid,
                const int* __restrict__ run_start,
                const int* __restrict__ run_len, int nruns,
                const float* __restrict__ xyz, long long xstride, Box box,
                float* __restrict__ out_d2, int* __restrict__ out_slot, int k,
                int row_base) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  __shared__ int ss[kTile];
  __shared__ Runs rs;
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int q0 = piece_q0[p];
  const bool active = t < piece_qn[p];
  knn::load_runs(rs, run_start, run_len, piece_pid[p], nruns);
  const int total = rs.pre[nruns];

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[q0 + t];
    qy = q[qstride + q0 + t];
    qz = q[2 * qstride + q0 + t];
  }
  float bd[K];
  int bs[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    bd[i] = __int_as_float(0x7f800000);  // +inf
    bs[i] = -1;
  }

  for (int c0 = 0; c0 < total; c0 += kTile) {
    for (int j = t; j < kTile && c0 + j < total; j += kQB) {
      const int s = knn::cand_slot(rs, nruns, c0 + j);
      sx[j] = xyz[s];
      sy[j] = xyz[xstride + s];
      sz[j] = xyz[2 * xstride + s];
      ss[j] = s;
    }
    __syncthreads();
    const int m = min(kTile, total - c0);
    if (active) {
      for (int j = 0; j < m; ++j) {
        const float d2 =
            knn::sq_dist<PERIODIC>(qx, qy, qz, sx[j], sy[j], sz[j], box);
        if (d2 < bd[K - 1]) {
          // strict compares: an equal earlier entry stays ahead
#pragma unroll
          for (int i = K - 1; i > 0; --i) {
            if (d2 < bd[i - 1]) {
              bd[i] = bd[i - 1];
              bs[i] = bs[i - 1];
            } else if (d2 < bd[i]) {
              bd[i] = d2;
              bs[i] = ss[j];
            }
          }
          if (d2 < bd[0]) {
            bd[0] = d2;
            bs[0] = ss[j];
          }
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    const long long row = static_cast<long long>(q0 - row_base + t) * k;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i < k) {
        out_d2[row + i] = bd[i];
        out_slot[row + i] = bs[i];
      }
    }
  }
}

template <int K>
int launch(bool periodic, int npieces, const float* q, long long qstride,
           const int* q0, const int* qn, const int* pid, const int* rstart,
           const int* rlen, int nruns, const float* xyz, long long xstride,
           const Box& box, float* out_d2, int* out_slot, int k, int row_base,
           cudaStream_t stream) {
  if (periodic)
    knn_topk_kernel<K, true><<<npieces, kQB, 0, stream>>>(
        q, qstride, q0, qn, pid, rstart, rlen, nruns, xyz, xstride, box,
        out_d2, out_slot, k, row_base);
  else
    knn_topk_kernel<K, false><<<npieces, kQB, 0, stream>>>(
        q, qstride, q0, qn, pid, rstart, rlen, nruns, xyz, xstride, box,
        out_d2, out_slot, k, row_base);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int knn_topk(const float* q, long long qstride, const int* piece_q0,
                        const int* piece_qn, const int* piece_pid,
                        int npieces, const int* run_start, const int* run_len,
                        int nruns, const float* xyz, long long xstride,
                        int periodic, float L0, float L1, float L2,
                        float iL0, float iL1, float iL2, float* out_d2,
                        int* out_slot, int k, int row_base,
                        cudaStream_t stream) {
  if (npieces <= 0 || nruns <= 0 || nruns > knn::kMaxRuns || k <= 0 ||
      k > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const Box box = {{L0, L1, L2}, {iL0, iL1, iL2}};
  const bool per = periodic != 0;
#define KNN_TOPK_CASE(K)                                                    \
  if (k <= K)                                                               \
    return launch<K>(per, npieces, q, qstride, piece_q0, piece_qn,          \
                     piece_pid, run_start, run_len, nruns, xyz, xstride,    \
                     box, out_d2, out_slot, k, row_base, stream);
  KNN_TOPK_CASE(1)
  KNN_TOPK_CASE(2)
  KNN_TOPK_CASE(4)
  KNN_TOPK_CASE(8)
  KNN_TOPK_CASE(16)
  KNN_TOPK_CASE(32)
  KNN_TOPK_CASE(64)
  KNN_TOPK_CASE(128)
#undef KNN_TOPK_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
