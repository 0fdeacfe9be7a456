// Candidate distance-block kernel (B4) of the k-NN engine: for every query of
// a piece, the squared distance to each of the piece's candidates, written as
// one row of a [rows][ncand] block (inf past the piece's candidate count).
// The k > 128 route selects from the block with a stable sort.
//
// Replaces nbodyhpc_tpu/ops/knn_pallas.py::_knn_kernel. The TPU kernel wrote
// a [128, NR * RCAP] block per packed 128-query block, one RCAP-lane slot per
// physical run with inf in the unused lanes; here a row holds the piece's
// candidates back to back in run-then-slot order, so column c of a row is
// candidate c of its piece and no lane decode is needed.
//
// Bound: device-memory writes. Each (query, candidate) pair costs ~15
// instructions and 4 bytes of output, so the kernel streams at the store
// rate. Threads stride over the candidates (column index), each loads its
// candidate once (coalesced within a run) and loops over the piece's queries
// held in shared memory; for a fixed query, neighbouring threads write
// neighbouring columns, so every store is coalesced.
#include <cuda_runtime.h>

#include "knn_common.h"

namespace {

using knn::Box;
using knn::kQB;
using knn::Runs;

constexpr int kThreads = 256;

template <bool PERIODIC>
__global__ void __launch_bounds__(kThreads)
knn_dist_kernel(const float* __restrict__ q, long long qstride,
                const int* __restrict__ piece_q0,
                const int* __restrict__ piece_qn,
                const int* __restrict__ piece_pid,
                const int* __restrict__ run_start,
                const int* __restrict__ run_len, int nruns,
                const float* __restrict__ xyz, long long xstride, Box box,
                float* __restrict__ out, int ncand, int row_base) {
  __shared__ float qs[3][kQB];
  __shared__ Runs rs;
  const int p = blockIdx.x;
  const int q0 = piece_q0[p];
  const int qn = piece_qn[p];
  for (int i = threadIdx.x; i < qn; i += kThreads) {
    qs[0][i] = q[q0 + i];
    qs[1][i] = q[qstride + q0 + i];
    qs[2][i] = q[2 * qstride + q0 + i];
  }
  knn::load_runs(rs, run_start, run_len, piece_pid[p], nruns);
  const int total = rs.pre[nruns];
  float* rows = out + static_cast<long long>(q0 - row_base) * ncand;
  const float inf = __int_as_float(0x7f800000);
  for (int c = threadIdx.x; c < ncand; c += kThreads) {
    if (c < total) {
      const int s = knn::cand_slot(rs, nruns, c);
      const float px = xyz[s], py = xyz[xstride + s], pz = xyz[2 * xstride + s];
      for (int i = 0; i < qn; ++i)
        rows[static_cast<long long>(i) * ncand + c] = knn::sq_dist<PERIODIC>(
            qs[0][i], qs[1][i], qs[2][i], px, py, pz, box);
    } else {
      for (int i = 0; i < qn; ++i)
        rows[static_cast<long long>(i) * ncand + c] = inf;
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int knn_dist(const float* q, long long qstride, const int* piece_q0,
                        const int* piece_qn, const int* piece_pid,
                        int npieces, const int* run_start, const int* run_len,
                        int nruns, const float* xyz, long long xstride,
                        int periodic, float L0, float L1, float L2,
                        float iL0, float iL1, float iL2, float* out,
                        int ncand, int row_base, cudaStream_t stream) {
  if (npieces <= 0 || nruns <= 0 || nruns > knn::kMaxRuns || ncand <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Box box = {{L0, L1, L2}, {iL0, iL1, iL2}};
  if (periodic)
    knn_dist_kernel<true><<<npieces, kThreads, 0, stream>>>(
        q, qstride, piece_q0, piece_qn, piece_pid, run_start, run_len, nruns,
        xyz, xstride, box, out, ncand, row_base);
  else
    knn_dist_kernel<false><<<npieces, kThreads, 0, stream>>>(
        q, qstride, piece_q0, piece_qn, piece_pid, run_start, run_len, nruns,
        xyz, xstride, box, out, ncand, row_base);
  return static_cast<int>(cudaGetLastError());
}
