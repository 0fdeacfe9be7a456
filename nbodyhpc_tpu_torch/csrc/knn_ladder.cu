// Expanding-cube ladder of the exact k-NN: every rung of ops/knn.py's
// `default_ladder` for each query row, in one launch.
//
// Replaces no TPU kernel: the JAX package's ladder (nbodyhpc_tpu/ops/knn.py
// `_cube_pass`) is plain XLA. Its torch port (ops/knn.py `ladder_rungs`)
// stays as this kernel's plain twin and runs on the CPU and for k > 128. On
// the card that twin is dozens of small launches a rung and a host sync
// between rungs, for the few rows the r = 1 bound of the kernel route leaves
// (2-4 of 5e5 self-queries at 1e7 uniform points): host scheduling, not
// work, bounds it. Here one launch takes each row through every rung.
//
// Per row, rung by rung (r, ccap), the same function as the twin:
// - the cube's (2r+1)^3 cell offsets in x-major order; a periodic axis wraps
//   and, where the cube spans the whole axis, keeps only its first `dims`
//   offsets; a plain axis drops cells off the grid;
// - each cell read through its ccap-wide window of the sorted storage, whose
//   start clamps to npad - ccap (the real rows are start .. start + taken,
//   taken = min(count, ccap - delta)); a cell fuller than its window sets
//   `overflow`;
// - the k best under (d2, candidate position m * ccap + j), the twin's stable
//   sort. The cells are walked in offset order and each cell's slots in
//   order, so positions arrive increasing: a candidate enters the list only
//   below the k-th best, and after every entry of equal d2 already in it;
// - the bound: `cube_bound`'s float32 db and `covered`, then conv =
//   !overflow && (kth < db * db || covered). The row stops at the first rung
//   that converges; a row that never does keeps its last rung's answer and
//   the host sends it to the brute pass;
// - the counters of `QueryStatistics`: cells and taken slots summed over the
//   rungs walked, cells_pruned = max(ncells - cells_scanned, 0) on the rung
//   that converges.
// Queries are wrapped and binned as ops/knn.py's `query_cells` does.
// Distances are sq_dist's expression with knn_common.h's wrap. Nothing may
// contract (build with --fmad=false).
//
// Design: one warp per row. A group of 32 cells takes a lane each (offsets,
// window, overflow), a warp scan of `taken` lays their slots end to end, and
// the warp then scores 32 consecutive candidates at a time: coalesced reads
// of the sorted storage whatever the cells' sizes, which the clustered
// capacity rung (27 cells of up to 2048 slots) needs. The k-list lives in
// registers, entry e * 32 + lane in register e of lane `lane`; a candidate
// below the k-th best is inserted by a ballot for its rank and one shuffle
// per register. What bounds it at the benchmark's few rows is latency: one
// warp walks its cells and candidates in turn.
//
// Outputs: d2 [nq][k] ascending, slot [nq][k] (-1 where d2 is inf),
// conv [nq], stats [3][nq] (cells scanned, points visited, cells pruned).
#include <cuda_runtime.h>

#include "knn_common.h"

namespace {

using knn::Box;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRungs = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Rungs {
  int n;
  int r[kMaxRungs];
  int ccap[kMaxRungs];
};

// The tree's grid: cells per axis, lower corner, cell size and its float32
// reciprocal (query_cells' 1 / h), and the padded slot count.
struct Grid {
  int C[3];
  float lo[3], h[3], inv_h[3];
  int ncells, npad;
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// Entry i (uniform over the warp) of the list.
template <int E>
__device__ __forceinline__ float entry(const float (&d)[E], int i) {
  float v = d[0];
#pragma unroll
  for (int e = 1; e < E; ++e)
    if (e == (i >> 5)) v = d[e];
  return __shfl_sync(kFull, v, i & 31);
}

// Insert (nd, ns), uniform over the warp, after every entry of d2 <= nd;
// the last entry falls off.
template <int E>
__device__ __forceinline__ void insert(float (&d)[E], int (&s)[E], float nd,
                                       int ns, int lane) {
  int p = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) p += __popc(__ballot_sync(kFull, d[e] <= nd));
  // from the last register down, so each shuffle reads the old values
#pragma unroll
  for (int e = E - 1; e >= 0; --e) {
    float pd = __shfl_up_sync(kFull, d[e], 1);
    int ps = __shfl_up_sync(kFull, s[e], 1);
    if (e > 0) {
      const float wd = __shfl_sync(kFull, d[e - 1], 31);
      const int ws = __shfl_sync(kFull, s[e - 1], 31);
      if (lane == 0) {
        pd = wd;
        ps = ws;
      }
    }
    const int idx = e * 32 + lane;
    if (idx == p) {
      d[e] = nd;
      s[e] = ns;
    } else if (idx > p) {
      d[e] = pd;
      s[e] = ps;
    }
  }
}

template <int E, bool PERIODIC>
__global__ void __launch_bounds__(kThreads)
knn_ladder_kernel(const float* __restrict__ queries, int nq,
                  const int* __restrict__ offsets,
                  const float* __restrict__ xyz, long long xs, Box box,
                  Grid g, Rungs rungs, int k, float* __restrict__ out_d2,
                  int* __restrict__ out_slot,
                  unsigned char* __restrict__ out_conv,
                  int* __restrict__ out_stats) {
  __shared__ int s_start[kWarps][32];
  __shared__ int s_pre[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= nq) return;  // the whole warp

  // the query wrapped by L and binned by 1/h in float32, as query_cells
  float qv[3];
  int qc[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float v = queries[3LL * row + a];
    if (PERIODIC) v = v - box.L[a] * floorf(v / box.L[a]);
    qv[a] = v;
    const float f = floorf((v - g.lo[a]) * g.inv_h[a]);
    const int C = g.C[a];
    if (PERIODIC) {
      int c = static_cast<int>(f) % C;
      qc[a] = c < 0 ? c + C : c;
    } else {
      // clipped in float, so a query far off the grid saturates
      qc[a] = f < 0.f ? 0 : (f > static_cast<float>(C - 1)
                                 ? C - 1 : static_cast<int>(f));
    }
  }

  float d[E];
  int s[E];
  int cells_scanned = 0, points_visited = 0, cells_pruned = 0;
  bool conv = false;
  for (int ri = 0; ri < rungs.n; ++ri) {
    const int r = rungs.r[ri], ccap = rungs.ccap[ri];
    const int side = 2 * r + 1, M = side * side * side;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      d[e] = inf();
      s[e] = -1;
    }
    float kth = inf();
    int nvalid = 0, ntaken = 0;
    bool overflow = false;

    for (int m0 = 0; m0 < M; m0 += 32) {
      const int m = m0 + lane;
      int start = 0, taken = 0;
      if (m < M) {
        const int o[3] = {m / (side * side) - r, (m / side) % side - r,
                          m % side - r};
        bool valid = true;
        int cc[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int C = g.C[a];
          if (PERIODIC) {
            valid = valid && o[a] + r < C;
            const int c = (qc[a] + o[a]) % C;
            cc[a] = c < 0 ? c + C : c;
          } else {
            const int c = qc[a] + o[a];
            valid = valid && c >= 0 && c < C;
            cc[a] = min(max(c, 0), C - 1);
          }
        }
        if (valid) {
          const int id = (cc[0] * g.C[1] + cc[1]) * g.C[2] + cc[2];
          start = __ldg(offsets + id);
          const int count = __ldg(offsets + id + 1) - start;
          const int usable = ccap - (start - min(start, g.npad - ccap));
          overflow = overflow || count > usable;
          taken = min(count, usable);
          nvalid += 1;
          ntaken += taken;
        }
      }
      // the group's taken slots end to end
      int incl = taken;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      __syncwarp();  // the previous group is read
      s_start[warp][lane] = start;
      s_pre[warp][lane] = incl - taken;
      __syncwarp();
      for (int b = 0; b < total; b += 32) {
        const int c = b + lane;
        float cd = inf();
        int cs = -1;
        if (c < total) {
          // the last cell of the group whose slots begin at or before c
          int lo = 0, hi = 32;
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (s_pre[warp][mid] <= c) lo = mid; else hi = mid;
          }
          cs = s_start[warp][lo] + (c - s_pre[warp][lo]);
          cd = knn::sq_dist<PERIODIC>(qv[0], qv[1], qv[2], __ldg(xyz + cs),
                                      __ldg(xyz + xs + cs),
                                      __ldg(xyz + 2 * xs + cs), box);
        }
        unsigned want = __ballot_sync(kFull, cd < kth);
        while (want) {  // lowest lane, so lowest position, first
          const int src = __ffs(want) - 1;
          want &= want - 1;
          const float nd = __shfl_sync(kFull, cd, src);
          const int ns = __shfl_sync(kFull, cs, src);
          if (!(nd < kth)) continue;
          insert<E>(d, s, nd, ns, lane);
          kth = entry<E>(d, k - 1);
        }
      }
    }
    cells_scanned += __reduce_add_sync(kFull, nvalid);
    points_visited += __reduce_add_sync(kFull, ntaken);
    overflow = __any_sync(kFull, overflow);

    // cube_bound, in the twin's float32 operations
    float db = inf();
    bool covered = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int C = g.C[a];
      const float h = g.h[a], lo = g.lo[a];
      float dlo, dhi;
      if (PERIODIC) {
        if (side >= C) continue;  // fully wrapped: no bound from this axis
        covered = false;
        dlo = qv[a] - (static_cast<float>(qc[a] - r) * h + lo);
        dhi = static_cast<float>(side) * h - dlo;
      } else {
        const int ca = max(qc[a] - r, 0), cb = min(qc[a] + r, C - 1);
        covered = covered && ca == 0 && cb == C - 1;
        dlo = ca > 0 ? qv[a] - (static_cast<float>(ca) * h + lo) : inf();
        dhi = cb < C - 1 ? (static_cast<float>(cb + 1) * h + lo) - qv[a]
                         : inf();
      }
      db = fminf(db, fmaxf(fminf(dlo, dhi), 0.f));
    }
    conv = !overflow && (kth < db * db || covered);
    if (conv) cells_pruned = max(g.ncells - cells_scanned, 0);
    if (conv) break;
  }

  const long long orow = static_cast<long long>(row) * k;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = e * 32 + lane;
    if (idx < k) {
      out_d2[orow + idx] = d[e];
      out_slot[orow + idx] = d[e] < inf() ? s[e] : -1;
    }
  }
  if (lane == 0) {
    out_conv[row] = conv ? 1 : 0;
    out_stats[row] = cells_scanned;
    out_stats[static_cast<long long>(nq) + row] = points_visited;
    out_stats[2LL * nq + row] = cells_pruned;
  }
}

template <int E>
int launch(bool periodic, const float* queries, int nq, const int* offsets,
           const float* xyz, long long xs, const Box& box, const Grid& g,
           const Rungs& rungs, int k, float* out_d2, int* out_slot,
           unsigned char* out_conv, int* out_stats, cudaStream_t stream) {
  const int blocks = (nq + kWarps - 1) / kWarps;
  if (periodic)
    knn_ladder_kernel<E, true><<<blocks, kThreads, 0, stream>>>(
        queries, nq, offsets, xyz, xs, box, g, rungs, k, out_d2, out_slot,
        out_conv, out_stats);
  else
    knn_ladder_kernel<E, false><<<blocks, kThreads, 0, stream>>>(
        queries, nq, offsets, xyz, xs, box, g, rungs, k, out_d2, out_slot,
        out_conv, out_stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). Rungs past
// `nrungs` are ignored; each given one needs r >= 1 and 1 <= ccap <= npad.
extern "C" int knn_ladder(const float* queries, int nq, const int* offsets,
                          const float* xyz, int npad, int periodic, float L0,
                          float L1, float L2, float iL0, float iL1, float iL2,
                          int C0, int C1, int C2, float lo0, float lo1,
                          float lo2, float h0, float h1, float h2, float ih0,
                          float ih1, float ih2, int nrungs, int r0, int cap0,
                          int r1, int cap1, int r2, int cap2, int r3,
                          int cap3, int k, float* out_d2, int* out_slot,
                          unsigned char* out_conv, int* out_stats,
                          cudaStream_t stream) {
  const Rungs rungs = {nrungs, {r0, r1, r2, r3}, {cap0, cap1, cap2, cap3}};
  if (nq <= 0 || k <= 0 || k > 128 || nrungs < 1 || nrungs > kMaxRungs ||
      C0 <= 0 || C1 <= 0 || C2 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < nrungs; ++i)
    if (rungs.r[i] < 1 || rungs.ccap[i] < 1 || rungs.ccap[i] > npad)
      return static_cast<int>(cudaErrorInvalidValue);
  const Box box = {{L0, L1, L2}, {iL0, iL1, iL2}};
  const Grid g = {{C0, C1, C2}, {lo0, lo1, lo2}, {h0, h1, h2},
                  {ih0, ih1, ih2}, C0 * C1 * C2, npad};
  const bool per = periodic != 0;
  if (k <= 32)
    return launch<1>(per, queries, nq, offsets, xyz, npad, box, g, rungs, k,
                     out_d2, out_slot, out_conv, out_stats, stream);
  if (k <= 64)
    return launch<2>(per, queries, nq, offsets, xyz, npad, box, g, rungs, k,
                     out_d2, out_slot, out_conv, out_stats, stream);
  return launch<4>(per, queries, nq, offsets, xyz, npad, box, g, rungs, k,
                   out_d2, out_slot, out_conv, out_stats, stream);
}
