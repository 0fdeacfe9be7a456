// Candidate top-k kernel (B3) of the k-NN engine: for every query of a piece,
// the exact k smallest squared distances over the piece's candidates,
// ascending, ties to the lowest candidate position in run-then-slot order,
// and the tree slot of each.
//
// Replaces nbodyhpc_tpu/ops/knn_pallas.py::_knn_topk_kernel. The TPU kernel
// DMA'd runs from 128-aligned floors into VMEM, rolled them to lane 0, packed
// up to 12 pieces into a 128-row block with a [128, NCAND] distance scratch,
// and extracted the top-k by kpad full-width min passes (or a two-level
// shortlist with an overflow flag). None of that carries over.
//
// What bounds it: the work the answer needs, not the candidate set. A FULLZ
// piece's candidates are its 3x3 neighbour columns over the full z extent
// (~7.7k points per query at 1e7 uniform points); the k nearest lie in the
// query's own 27-cell cube (~214 points). Scanning every candidate costs
// ~36x the needed pairs, and a warp pays the K-deep insertion whenever one
// lane inserts, which the z-ordered scan of a column makes frequent. So:
//
// - One thread per query row, a flat grid over the sorted rows (a binary
//   search of piece_q0 gives the row's piece), so no lane idles for want of
//   queries.
// - Each run is a contiguous range of cell ids (x-major, then y, then z), so
//   it splits into column segments with a z interval each. The query first
//   scores the cells within one z-cell of its own cell in every column
//   segment (the window), then walks each column up and down from there.
// - Every cell is scanned only if a lower bound on the float32 d2 of any
//   point in it does not exceed the current k-th best; a walk stops at the
//   first cell whose bound exceeds it, since the exact gap from the query to
//   the cells grows along the walk. The bound is the distance from the query
//   to the cell's slab per axis, minus a margin for float32 rounding of the
//   cell assignment and of the displacement (relative 2^-20, absolute
//   2^-16 x the axis's coordinate scale), put through the same fmaf chain
//   as d2 (rounding is monotone). Equality never skips.
// - The top-K (K = next power of two >= k, at most 128) is kept sorted in
//   registers by the pair (d2, candidate position), the position being
//   pre[r] + (slot - start[r]): this is the stable sort's tie rule whatever
//   order the cells are visited in. K - k placeholders at -inf lead the
//   list, so its last entry is the k-th best. Positions turn back into slots
//   at the end.
// - The min-image wrap is a compare-and-select (knn_common.h), no rintf.
//
// What bounds it now: at 1e7 uniform points and k = 16 a query scores ~160
// pairs in ~20 cells, yet the kernel runs at a few percent of the byte
// bound (reading every point once). Each lane walks its cells one after
// another (a load of the cell's offsets, then of its points), and a warp
// pays the K-deep insertion whenever one lane inserts. Code that grows with
// K costs time and registers at every k: the k-th best is read at a fixed
// index and the slot decode is not unrolled. Staging a warp's shared window
// cells in shared memory is the next lever.
//
// Output: d2 [nrows][k] float32 and the tree slot [nrows][k] int32 of rows
// row_base .. row_base + nrows; unfilled entries, and rows no piece covers,
// are inf / -1. With a non-null `counts`, the kernel adds the (query,
// point) pairs it scored to counts[0] and the cells it scanned to counts[1].
#include <cuda_runtime.h>

#include <climits>

#include "knn_common.h"

namespace {

using knn::Box;

constexpr int kThreads = 128;

// The tree's cell grid, per axis: cells, lower corner, cell size, its
// float32 reciprocal (as the build bins points) and the bound's margin.
struct Grid {
  int C[3];
  float lo[3], h[3], inv_h[3], marg[3];
};

// Per query and axis: the cell the query is measured from, and the offset
// f = q - (cell * h + lo) of the query inside it.
struct Axis {
  int c;
  float f;
};

template <bool PERIODIC>
__device__ __forceinline__ Axis query_axis(float q, const Grid& g, int d) {
  int c = static_cast<int>(floorf((q - g.lo[d]) * g.inv_h[d]));
  const int C = g.C[d];
  if (PERIODIC) {
    c %= C;
    if (c < 0) c += C;
  } else {
    c = min(max(c, 0), C - 1);
  }
  return {c, q - (static_cast<float>(c) * g.h[d] + g.lo[d])};
}

// Exact-arithmetic distance from the query to the slab of the cell at
// offset m from its own (all periodic images), less the rounding margin.
__device__ __forceinline__ float slab_gap(int m, float f, float h) {
  const float below = static_cast<float>(m) * h - f;
  const float above = f - static_cast<float>(m + 1) * h;
  return fmaxf(fmaxf(below, above), 0.f);
}

template <bool PERIODIC>
__device__ __forceinline__ float axis_gap(int m, const Axis& a, const Grid& g,
                                          int d) {
  float gap = slab_gap(m, a.f, g.h[d]);
  if (PERIODIC) {
    gap = fminf(gap, slab_gap(m - g.C[d], a.f, g.h[d]));
    gap = fminf(gap, slab_gap(m + g.C[d], a.f, g.h[d]));
  }
  return fmaxf(gap * (1.f - 0x1p-20f) - g.marg[d], 0.f);
}

__device__ __forceinline__ bool before(float d, int p, float bd, int bp) {
  return d < bd || (d == bd && p < bp);
}

// The k best so far, sorted by (d2, position) in K >= k registers: entries
// 0 .. K - k - 1 are placeholders at -inf that no candidate displaces, so
// entry K - 1 is always the k-th best and every test reads it at a constant
// index.
template <int K>
struct TopK {
  float d[K];
  int p[K];

  __device__ __forceinline__ void init(int k) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const bool real = i >= K - k;
      const float inf = __int_as_float(0x7f800000);
      d[i] = real ? inf : -inf;
      p[i] = real ? INT_MAX : INT_MIN;
    }
  }

  // Insert (dv, pv) into the list sorted by (d2, position); positions are
  // unique, so the order is strict.
  __device__ __forceinline__ void push(float dv, int pv) {
    if (!before(dv, pv, d[K - 1], p[K - 1])) return;
#pragma unroll
    for (int i = K - 1; i > 0; --i) {
      if (before(dv, pv, d[i - 1], p[i - 1])) {
        d[i] = d[i - 1];
        p[i] = p[i - 1];
      } else if (before(dv, pv, d[i], p[i])) {
        d[i] = dv;
        p[i] = pv;
      }
    }
    if (before(dv, pv, d[0], p[0])) {
      d[0] = dv;
      p[0] = pv;
    }
  }

  // The k-th smallest d2 so far (inf until k candidates were seen).
  __device__ __forceinline__ float kth() const { return d[K - 1]; }
};

// Everything one query needs while it visits cells.
template <int K, bool PERIODIC>
struct Query {
  float x, y, z;
  Axis ax[3];
  TopK<K> top;
  int pairs, cells;  // a query scores fewer pairs than the tree has slots
};

template <int K, bool PERIODIC>
__device__ __forceinline__ void scan_cell(Query<K, PERIODIC>& q, int cell,
                                          int base,
                                          const int* __restrict__ offsets,
                                          const float* __restrict__ xyz,
                                          long long xs, const Box& box) {
  const int s0 = __ldg(offsets + cell);
  const int s1 = __ldg(offsets + cell + 1);
  q.pairs += s1 - s0;
  q.cells += 1;
  for (int s = s0; s < s1; ++s) {
    const float d2 = knn::sq_dist<PERIODIC>(
        q.x, q.y, q.z, __ldg(xyz + s), __ldg(xyz + xs + s),
        __ldg(xyz + 2 * xs + s), box);
    q.top.push(d2, base + s);
  }
}

// Up to k = 16, four blocks per SM (at most 128 registers a thread) timed
// best of one to four on the H100.
template <int K, bool PERIODIC>
__global__ void __launch_bounds__(kThreads, K <= 16 ? 4 : 1)
knn_topk_kernel(const float* __restrict__ qv, long long qstride,
                const int* __restrict__ piece_q0,
                const int* __restrict__ piece_qn,
                const int* __restrict__ piece_pid, int npieces,
                const int* __restrict__ run_start,
                const int* __restrict__ run_len,
                const int* __restrict__ run_cell,
                const int* __restrict__ run_ncell, int nruns,
                const int* __restrict__ offsets,
                const float* __restrict__ xyz, long long xs, Box box, Grid g,
                float* __restrict__ out_d2, int* __restrict__ out_slot, int k,
                int row_base, int nrows,
                unsigned long long* __restrict__ counts) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nrows) return;
  const int row = row_base + i;
  // the piece holding this row: the last with piece_q0 <= row
  int lo = 0, hi = npieces;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(piece_q0 + mid) <= row) lo = mid; else hi = mid;
  }
  const int q0 = __ldg(piece_q0 + lo);
  const bool covered = q0 <= row && row < q0 + __ldg(piece_qn + lo);
  const long long orow = static_cast<long long>(i) * k;
  if (!covered) {
    for (int j = 0; j < k; ++j) {
      out_d2[orow + j] = __int_as_float(0x7f800000);
      out_slot[orow + j] = -1;
    }
    return;
  }
  const int prow = __ldg(piece_pid + lo) * nruns;
  const int* rst = run_start + prow;
  const int* rln = run_len + prow;
  const int* rc0 = run_cell + prow;
  const int* rnc = run_ncell + prow;

  Query<K, PERIODIC> q;
  q.x = qv[row];
  q.y = qv[qstride + row];
  q.z = qv[2 * qstride + row];
  q.ax[0] = query_axis<PERIODIC>(q.x, g, 0);
  q.ax[1] = query_axis<PERIODIC>(q.y, g, 1);
  q.ax[2] = query_axis<PERIODIC>(q.z, g, 2);
  q.top.init(k);
  q.pairs = q.cells = 0;
  const int Cy = g.C[1], Cz = g.C[2];
  const int qz = q.ax[2].c;

  // Each run's cell range splits into column segments, each with the z
  // interval [za, zb). Phase 0 scores the window of every segment, phase 1
  // walks them; no cell is visited by both. Not unrolled: one scan site.
#pragma unroll 1
  for (int phase = 0; phase < 2; ++phase) {
    int pre = 0;
    for (int r = 0; r < nruns; ++r) {
      const int c0 = __ldg(rc0 + r), nc = __ldg(rnc + r);
      const int base = pre - __ldg(rst + r);
      pre += __ldg(rln + r);
      if (nc <= 0) continue;
      for (int col = c0 / Cz; col <= (c0 + nc - 1) / Cz; ++col) {
        const int za = max(c0, col * Cz) - col * Cz;
        const int zb = min(c0 + nc, (col + 1) * Cz) - col * Cz;
        const int cx = col / Cy, cy = col - (col / Cy) * Cy;
        const float gx = axis_gap<PERIODIC>(cx - q.ax[0].c, q.ax[0], g, 0);
        const float gy = axis_gap<PERIODIC>(cy - q.ax[1].c, q.ax[1], g, 1);
        const float gxy = fmaf(gx, gx, gy * gy);
        if (gxy > q.top.kth()) continue;  // no cell of it can reach
        const int cell0 = col * Cz;
        // One scan site (the insertion unrolls once): phase 0 takes the
        // window's offsets 0, +1, -1 (each z once), phase 1 walks up over
        // offsets 2..mu, then down over 2..md, each walk ending at the
        // first offset whose bound exceeds the k-th best.
        const int nw = PERIODIC ? min(Cz, 3) : 3;
        const int mu = PERIODIC ? Cz / 2 : Cz - 1 - qz;
        const int md = PERIODIC ? (Cz + 1) / 2 - 1 : qz;
        int step = 0, dir = 1;
        for (;;) {
          int m;
          if (phase == 0) {
            if (step >= nw) break;
            m = step == 0 ? 0 : (step == 1 ? 1 : -1);
          } else {
            if (step + 2 > (dir > 0 ? mu : md)) {
              if (dir < 0) break;
              dir = -1;
              step = 0;
              continue;
            }
            m = dir * (step + 2);
          }
          ++step;
          const float gz = axis_gap<PERIODIC>(m, q.ax[2], g, 2);
          if (fmaf(gz, gz, gxy) > q.top.kth()) {
            if (phase == 0) continue;
            if (dir < 0) break;
            dir = -1;  // the rest of the up walk lies farther still
            step = 0;
            continue;
          }
          int z = qz + m;
          if (PERIODIC) z = z < 0 ? z + Cz : (z >= Cz ? z - Cz : z);
          if (z < za || z >= zb) continue;
          scan_cell(q, cell0 + z, base, offsets, xyz, xs, box);
        }
      }
    }
  }

  // the k real entries out, positions first (-1 where none was found) ...
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j >= K - k) {
      const float d = q.top.d[j];
      out_d2[orow + j - (K - k)] = d;
      out_slot[orow + j - (K - k)] =
          d < __int_as_float(0x7f800000) ? q.top.p[j] : -1;
    }
  }
  // ... then back to tree slots (run r holds positions pre[r] ..), in a loop
  // that does not unroll with K
  for (int j = 0; j < k; ++j) {
    const int pos = out_slot[orow + j];
    if (pos < 0) continue;
    int pre = 0;
    for (int r = 0; r < nruns; ++r) {
      const int len = __ldg(rln + r);
      if (pos < pre + len) {
        out_slot[orow + j] = __ldg(rst + r) + (pos - pre);
        break;
      }
      pre += len;
    }
  }
  if (counts != nullptr) {
    atomicAdd(counts, static_cast<unsigned long long>(q.pairs));
    atomicAdd(counts + 1, static_cast<unsigned long long>(q.cells));
  }
}

struct Args {
  const float* q;
  long long qstride;
  const int *q0, *qn, *pid;
  int npieces;
  const int *rstart, *rlen, *rcell, *rncell;
  int nruns;
  const int* offsets;
  const float* xyz;
  long long xstride;
  Box box;
  Grid grid;
  float* out_d2;
  int* out_slot;
  int k, row_base, nrows;
  unsigned long long* counts;
};

template <int K>
int launch(bool periodic, const Args& a, cudaStream_t stream) {
  const int blocks = (a.nrows + kThreads - 1) / kThreads;
#define KNN_TOPK_LAUNCH(P)                                                   \
  knn_topk_kernel<K, P><<<blocks, kThreads, 0, stream>>>(                    \
      a.q, a.qstride, a.q0, a.qn, a.pid, a.npieces, a.rstart, a.rlen,        \
      a.rcell, a.rncell, a.nruns, a.offsets, a.xyz, a.xstride, a.box,        \
      a.grid, a.out_d2, a.out_slot, a.k, a.row_base, a.nrows, a.counts)
  if (periodic)
    KNN_TOPK_LAUNCH(true);
  else
    KNN_TOPK_LAUNCH(false);
#undef KNN_TOPK_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int knn_topk(const float* q, long long qstride, const int* piece_q0,
                        const int* piece_qn, const int* piece_pid,
                        int npieces, const int* run_start, const int* run_len,
                        const int* run_cell, const int* run_ncell, int nruns,
                        const int* offsets, const float* xyz,
                        long long xstride, int periodic, float L0, float L1,
                        float L2, float iL0, float iL1, float iL2, int C0,
                        int C1, int C2, float lo0, float lo1, float lo2,
                        float h0, float h1, float h2, float ih0, float ih1,
                        float ih2, float m0, float m1, float m2,
                        float* out_d2, int* out_slot, int k, int row_base,
                        int nrows, unsigned long long* counts,
                        cudaStream_t stream) {
  if (npieces <= 0 || nruns <= 0 || nruns > knn::kMaxRuns || k <= 0 ||
      k > 128 || nrows <= 0 || C0 <= 0 || C1 <= 0 || C2 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {q, qstride, piece_q0, piece_qn, piece_pid, npieces,
                  run_start, run_len, run_cell, run_ncell, nruns, offsets,
                  xyz, xstride, {{L0, L1, L2}, {iL0, iL1, iL2}},
                  {{C0, C1, C2}, {lo0, lo1, lo2}, {h0, h1, h2},
                   {ih0, ih1, ih2}, {m0, m1, m2}},
                  out_d2, out_slot, k, row_base, nrows, counts};
  const bool per = periodic != 0;
#define KNN_TOPK_CASE(K) \
  if (k <= K) return launch<K>(per, a, stream);
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
