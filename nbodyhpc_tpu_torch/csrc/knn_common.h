// Shared pieces of the k-NN candidate kernels (knn_topk.cu, knn_dist.cu).
//
// A *piece* is a group of at most kQB queries that scan the same candidate
// set: the logical runs (start, len) of its plan row, slices of the
// cell-sorted point storage xyz [4][xstride] (rows x, y, z, pad). Candidate c
// of a piece is the c-th point of the concatenated runs, so candidates are
// visited in run order, then slot order -- the order that decides ties.
//
// Distances are the JAX package's float32 expression: per dimension
// d = q - p, min-image wrapped as d - L * rint(d * invL) when periodic (rint
// rounds half to even, like jnp.round; invL = float(1.0 / L) comes from the
// host), then d2 = fmaf(dz, dz, fmaf(dx, dx, dy * dy)): the JAX package's
// `d2 = d2 + d * d` loop as XLA contracts it on the CPU, where the parity
// tests run. The fused multiply-adds are explicit; everything else must not
// contract, so build with --fmad=false.
//
// The wrap is computed without rintf (a conversion-class instruction, 16 per
// clock per SM on sm_90 against 128 for FP32 arithmetic): with t = d * invL
// and |t| < 1.5, rint(t) is 1 for t > 0.5, -1 for t < -0.5 and 0 otherwise
// (half to even sends +-0.5 to 0), and L * (+-1) is exact, so the selects
// d - L, d + L and d give the same float32 value as d - L * rint(t) (up to
// the sign of a zero, which the square removes). Every displacement here
// lies in [-L, L]: queries are wrapped into [0, L), points lie in [0, L].
#pragma once

#include <cuda_runtime.h>

namespace knn {

constexpr int kQB = 64;        // queries per piece (B4 stages them)
constexpr int kMaxRuns = 36;   // logical runs per plan row (ZSEG: 36, FULLZ: 6)

struct Box {
  float L[3];
  float invL[3];
};

// The piece's run table in shared memory: start slot of each run and the
// exclusive prefix of the run lengths (pre[nruns] = total candidates).
struct Runs {
  int start[kMaxRuns];
  int pre[kMaxRuns + 1];
};

__device__ inline void load_runs(Runs& rs, const int* __restrict__ run_start,
                                 const int* __restrict__ run_len, int pid,
                                 int nruns) {
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int r = 0; r < nruns; ++r) {
      rs.start[r] = run_start[pid * nruns + r];
      rs.pre[r] = acc;
      acc += run_len[pid * nruns + r];
    }
    rs.pre[nruns] = acc;
  }
  __syncthreads();
}

// Tree slot of candidate c (0 <= c < pre[nruns]). Zero-length runs are
// skipped because their prefix entry equals the next one.
__device__ inline int cand_slot(const Runs& rs, int nruns, int c) {
  int r = 0;
  while (r + 1 < nruns && rs.pre[r + 1] <= c) ++r;
  return rs.start[r] + (c - rs.pre[r]);
}

template <bool PERIODIC>
__device__ inline float wrap(float d, float L, float invL) {
  if (!PERIODIC) return d;
  const float t = d * invL;
  return t > 0.5f ? d - L : (t < -0.5f ? d + L : d);
}

template <bool PERIODIC>
__device__ inline float sq_dist(float qx, float qy, float qz, float px,
                                float py, float pz, const Box& b) {
  const float dx = wrap<PERIODIC>(qx - px, b.L[0], b.invL[0]);
  const float dy = wrap<PERIODIC>(qy - py, b.L[1], b.invL[1]);
  const float dz = wrap<PERIODIC>(qz - pz, b.L[2], b.invL[2]);
  return fmaf(dz, dz, fmaf(dx, dx, dy * dy));
}

}  // namespace knn
