// Candidate distance kernel (B4) of the k-NN engine: one tiled body that
// scores every query of a piece against each of the piece's candidates, with
// two sinks for the squared distances.
//
//   knn_select  the k smallest of every row, ascending, ties to the lowest
//               candidate position, with their tree slots (128 < k <= 256 on
//               the engine's path). The distances never leave the SM.
//   knn_dist    every distance, as one row of a [rows][ncand] block (inf past
//               the piece's candidate count); a stable sort outside the
//               kernel selects from it. Taken above knn_select's capacity.
//
// Replaces nbodyhpc_tpu/ops/knn_pallas.py::_knn_kernel, and for knn_select
// also the selection that followed it there (_topk_blocks). The TPU kernel
// filled a [128, NR * RCAP] block per packed 128-query block, one RCAP-lane
// slot per physical run, and left the top-k to a second pass over that block
// in device memory; its layout is not kept. Here a row's candidates are the
// piece's runs back to back in run-then-slot order, so candidate position c
// is column c of the block, and the position decides ties.
//
// The shared body. A block takes one piece and a group of at most kRows = 16
// of its query rows (grid y; a piece of 64 rows spreads over four blocks, its
// rows dealt round-robin so the groups are even). The piece's candidates are
// staged through shared memory in tiles of kTile positions, two stages: while
// a tile is scored, cp.async copies the next one. A run is a contiguous slice
// of xyz, so a tile is filled run by run (the run table is walked once per
// tile and run, never per candidate); run starts are arbitrary slots, hence
// 4-byte copies. Each warp owns two rows, whose queries sit in registers; its
// lanes stride the tile in ascending position. Distances are knn::sq_dist,
// so every d2 keeps the bits of the plain version.
//
// Bound: knn_select by its float32 instructions (about 18 per pair, against
// 12 bytes per candidate, query and 8 k bytes of result per row); knn_dist by
// the block's stores (4 bytes per pair).
//
// knn_select's sink. Each row keeps a list of kCap = 512 keys in shared
// memory, key = (d2 bits << 32) | position: d2 >= 0, so the unsigned order
// of its bits is its float order, and one 64-bit compare gives the stable
// sort's order. A candidate enters only if its d2 bits lie below tau, a bound
// under which at least k held keys lie (the bits of inf until the first
// compaction, so a non-finite d2 never enters). The compare is strict:
// positions only grow, so a later candidate with d2 == tau ranks behind k
// held keys. A ballot and a prefix count append a warp's survivors in lane
// order; tau, the list and its count belong to one warp, so nothing races.
// The warp first votes once over a whole step of 64 positions and both rows,
// since most steps hold no survivor.
// When fewer than 32 slots are free the warp compacts: with the 16 keys of
// each lane in registers it bisects, bit by bit from the highest bit in
// which the keys differ, for a key bound that at least k keys do not exceed,
// stops as soon as at most k + (kCap - k) / 4 keys pass (all 64 bits resolve
// to exactly k, so ties cannot overflow the list), keeps those and lowers tau
// to the bound's d2 bits. After the last tile one compaction with no slack
// leaves min(k, candidates) keys; a bitonic sort in shared memory orders
// them, and the row writes d2 and the slot its position decodes to (inf and
// -1 beyond the piece's candidates).
//
// Shared memory: lists 16 rows x 512 keys x 8 B = 64 KB and tiles 2 x 3 x
// 1024 x 4 B = 24 KB, 88 KB a block, so two blocks (16 warps) fit the 227 KB
// of an SM; 32 rows a block would hold one. The capacity, k <= kCap / 2 =
// 256, keeps half of the list as buffer at the largest k. k is a runtime
// value: no code grows with it.
//
// knn_dist's sink. Each lane scores four neighbouring positions of the
// staged tile and writes them as one 16-byte store where the row length is
// a multiple of 4 floats (the engine pads it to 32, so every row starts on a
// 128-byte line); other lengths take scalar stores.
#include <cuda_runtime.h>

#include "knn_common.h"

namespace {

using knn::Box;
using knn::kQB;
using knn::Runs;

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kGroups = kQB / kRows;          // blocks a full piece spreads over
constexpr int kTile = 1024;                   // candidate positions per tile
constexpr int kChunks = 2;                    // 32-position chunks per step
constexpr int kCap = 512;                     // keys per row list
constexpr int kKeysPerLane = kCap / 32;
constexpr int kSelectMax = kCap / 2;          // largest k of knn_select
constexpr unsigned kInfBits = 0x7f800000u;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kTileBytes = 2 * 3 * kTile * sizeof(float);
constexpr size_t kListBytes = static_cast<size_t>(kRows) * kCap * sizeof(u64);

__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of candidate positions [lo, hi) into a stage (x, y, z rows
// of kTile floats): the part of every run that lies in the range.
__device__ inline void stage_tile(float* stage, const Runs& rs, int nruns,
                                  int lo, int hi,
                                  const float* __restrict__ xyz,
                                  long long xstride) {
  for (int r = 0; r < nruns; ++r) {
    const int a = max(rs.pre[r], lo), b = min(rs.pre[r + 1], hi);
    if (a >= b) continue;
    const float* src = xyz + rs.start[r] + (a - rs.pre[r]);
    float* dst = stage + (a - lo);
    for (int i = threadIdx.x; i < b - a; i += kThreads) {
      cp_async4(dst + i, src + i);
      cp_async4(dst + kTile + i, src + xstride + i);
      cp_async4(dst + 2 * kTile + i, src + 2 * xstride + i);
    }
  }
}

__device__ inline u64 warp_min(u64 v) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 w = __shfl_xor_sync(kFull, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__device__ inline u64 warp_max(u64 v) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// One warp cuts its row's list of cnt keys down to between k and k + slack
// keys (or leaves it, if it holds no more): returns (new count, tau), tau
// the d2 bits of a key bound that all kept keys respect.
__device__ __noinline__ uint2 compact(u64* list, int cnt, unsigned tau, int k,
                                      int slack) {
  __syncwarp();
  if (cnt <= k + slack) return make_uint2(cnt, tau);
  const int lane = threadIdx.x & 31;
  u64 key[kKeysPerLane];
  u64 mn = ~0ull, mx = 0;
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) {
    const int i = lane + 32 * j;
    const bool held = i < cnt;
    key[j] = held ? list[i] : ~0ull;
    mn = key[j] < mn ? key[j] : mn;
    mx = held && key[j] > mx ? key[j] : mx;
  }
  mn = warp_min(mn);
  mx = warp_max(mx);
  // keys are distinct and cnt >= 2, so mn != mx; the k-th smallest key lies
  // in [prefix, ub], and h keys do not exceed ub
  const int top = 63 - __clzll(static_cast<long long>(mn ^ mx));
  const u64 below = (2ull << top) - 1;
  u64 prefix = mx & ~below, ub = mx | below;
  int h = cnt;
  for (int b = top; b >= 0 && h > k + slack; --b) {
    const u64 trial = prefix | (1ull << b);
    int c = 0;
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) c += key[j] < trial;
    c = __reduce_add_sync(kFull, c);
    if (c >= k) {
      ub = trial - 1;
      h = c;
    } else {
      prefix = trial;
    }
  }
  __syncwarp();
  int base = 0;
  const unsigned lt = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) {
    const bool keep = key[j] <= ub;
    const unsigned bal = __ballot_sync(kFull, keep);
    if (keep) list[base + __popc(bal & lt)] = key[j];
    base += __popc(bal);
  }
  __syncwarp();
  return make_uint2(base, min(static_cast<unsigned>(ub >> 32), kInfBits));
}

// One warp sorts its row's m <= k kept keys and writes the row's answer.
__device__ __noinline__ void finish_row(u64* list, int m, int k, const Runs& rs,
                                        int nruns, float* __restrict__ od,
                                        int* __restrict__ os) {
  const int lane = threadIdx.x & 31;
  int n2 = 32;
  while (n2 < m) n2 <<= 1;
  for (int i = m + lane; i < n2; i += 32) list[i] = ~0ull;
  __syncwarp();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n2 / 2; t += 32) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const u64 a = list[i], b = list[j];
        if ((a > b) == ((i & size) == 0)) {
          list[i] = b;
          list[j] = a;
        }
      }
      __syncwarp();
    }
  }
  for (int j = lane; j < k; j += 32) {
    if (j < m) {
      const u64 key = list[j];
      od[j] = __uint_as_float(static_cast<unsigned>(key >> 32));
      os[j] = knn::cand_slot(rs, nruns, static_cast<int>(key & 0xffffffffu));
    } else {
      od[j] = __uint_as_float(kInfBits);
      os[j] = -1;
    }
  }
}

// SELECT: out_d2/out_slot are [nrows][width = k]. Otherwise out_d2 is the
// [nrows][width = ncand] block and out_slot is unused.
template <bool PERIODIC, bool SELECT>
__global__ void __launch_bounds__(kThreads, 2)
knn_tile_kernel(const float* __restrict__ q, long long qstride,
                const int* __restrict__ piece_q0,
                const int* __restrict__ piece_qn,
                const int* __restrict__ piece_pid,
                const int* __restrict__ run_start,
                const int* __restrict__ run_len, int nruns,
                const float* __restrict__ xyz, long long xstride, Box box,
                float* __restrict__ out_d2, int* __restrict__ out_slot,
                int width, int row_base) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Runs rs;
  float* tiles = reinterpret_cast<float*>(smem);
  const int p = blockIdx.x;
  const int qn = piece_qn[p];
  const int ngroups = (qn + kRows - 1) / kRows;
  const int g = blockIdx.y;
  if (g >= ngroups) return;
  const int q0 = piece_q0[p];
  knn::load_runs(rs, run_start, run_len, piece_pid[p], nruns);
  const int total = rs.pre[nruns];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the warp's rows: the group's j-th row is piece row g + ngroups * j
  bool has[kRowsPerWarp];
  long long orow[kRowsPerWarp];
  float qx[kRowsPerWarp], qy[kRowsPerWarp], qz[kRowsPerWarp];
  u64* list[kRowsPerWarp];
  int cnt[kRowsPerWarp];
  unsigned tau[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int j = warp + kWarps * r;
    const int pr = g + ngroups * j;
    has[r] = pr < qn;
    const int row = q0 + (has[r] ? pr : 0);
    orow[r] = static_cast<long long>(row - row_base) * width;
    qx[r] = q[row];
    qy[r] = q[qstride + row];
    qz[r] = q[2 * qstride + row];
    list[r] = reinterpret_cast<u64*>(smem + kTileBytes) + j * kCap;
    cnt[r] = 0;
    tau[r] = has[r] ? kInfBits : 0;  // nothing enters the list of no row
  }
  const int slack = (kCap - width) / 4;  // SELECT only
  const unsigned lt = (1u << lane) - 1;
  const bool vec = (width & 3) == 0;     // block sink only
  const float inf = __uint_as_float(kInfBits);

  const int extent = SELECT ? total : width;
  const int ntiles = (extent + kTile - 1) / kTile;
  if (ntiles > 0) {
    if (total > 0)
      stage_tile(tiles, rs, nruns, 0, min(kTile, total), xyz, xstride);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    const int lo = t * kTile;
    if (t + 1 < ntiles) {
      const int nlo = lo + kTile, nhi = min(nlo + kTile, total);
      if (nlo < nhi)
        stage_tile(tiles + ((t + 1) & 1) * 3 * kTile, rs, nruns, nlo, nhi, xyz,
                   xstride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sx = tiles + (t & 1) * 3 * kTile;
    const float* sy = sx + kTile;
    const float* sz = sy + kTile;
    if (SELECT) {
      // kChunks x 32 positions a step: all loads, then all distances, then
      // the appends in ascending position (positions past n fail `ok`)
      const int n = min(kTile, total - lo);
      for (int base = 0; base < n; base += 32 * kChunks) {
        float px[kChunks], py[kChunks], pz[kChunks];
        unsigned d2[kRowsPerWarp][kChunks];
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
          const int i = base + 32 * u + lane;
          px[u] = sx[i];
          py[u] = sy[i];
          pz[u] = sz[i];
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int u = 0; u < kChunks; ++u)
            d2[r][u] = __float_as_uint(knn::sq_dist<PERIODIC>(
                qx[r], qy[r], qz[r], px[u], py[u], pz[u], box));
        // one vote for the whole step: most steps hold no survivor
        bool any = false;
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
          const bool ok = base + 32 * u + lane < n;
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            any |= ok && d2[r][u] < tau[r];
        }
        if (!__any_sync(kFull, any)) continue;
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
          const int i = base + 32 * u + lane;
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const bool in = i < n && d2[r][u] < tau[r];
            const unsigned bal = __ballot_sync(kFull, in);
            if (bal == 0) continue;
            if (in)
              list[r][cnt[r] + __popc(bal & lt)] =
                  (static_cast<u64>(d2[r][u]) << 32) |
                  static_cast<unsigned>(lo + i);
            cnt[r] += __popc(bal);
            if (cnt[r] > kCap - 32) {
              const uint2 ct = compact(list[r], cnt[r], tau[r], width, slack);
              cnt[r] = ct.x;
              tau[r] = ct.y;
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (!has[r]) continue;
        float* dst = out_d2 + orow[r] + lo;
        for (int base = 0; base < kTile && lo + base < width; base += 128) {
          const int c = base + 4 * lane;
          const float4 px = *reinterpret_cast<const float4*>(sx + c);
          const float4 py = *reinterpret_cast<const float4*>(sy + c);
          const float4 pz = *reinterpret_cast<const float4*>(sz + c);
          float4 d;
          d.x = knn::sq_dist<PERIODIC>(qx[r], qy[r], qz[r], px.x, py.x, pz.x,
                                       box);
          d.y = knn::sq_dist<PERIODIC>(qx[r], qy[r], qz[r], px.y, py.y, pz.y,
                                       box);
          d.z = knn::sq_dist<PERIODIC>(qx[r], qy[r], qz[r], px.z, py.z, pz.z,
                                       box);
          d.w = knn::sq_dist<PERIODIC>(qx[r], qy[r], qz[r], px.w, py.w, pz.w,
                                       box);
          const int pos = lo + c;
          if (pos + 0 >= total) d.x = inf;
          if (pos + 1 >= total) d.y = inf;
          if (pos + 2 >= total) d.z = inf;
          if (pos + 3 >= total) d.w = inf;
          if (vec) {
            if (pos < width) *reinterpret_cast<float4*>(dst + c) = d;
          } else {
            if (pos + 0 < width) dst[c + 0] = d.x;
            if (pos + 1 < width) dst[c + 1] = d.y;
            if (pos + 2 < width) dst[c + 2] = d.z;
            if (pos + 3 < width) dst[c + 3] = d.w;
          }
        }
      }
    }
    __syncthreads();
  }
  if (SELECT) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (!has[r]) continue;
      const uint2 ct = compact(list[r], cnt[r], tau[r], width, 0);
      finish_row(list[r], ct.x, width, rs, nruns, out_d2 + orow[r],
                 out_slot + orow[r]);
    }
  }
}

template <bool SELECT>
int launch(const float* q, long long qstride, const int* piece_q0,
           const int* piece_qn, const int* piece_pid, int npieces,
           const int* run_start, const int* run_len, int nruns,
           const float* xyz, long long xstride, int periodic, const Box& box,
           float* out_d2, int* out_slot, int width, int row_base,
           cudaStream_t stream) {
  if (npieces <= 0 || nruns <= 0 || nruns > knn::kMaxRuns || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = kTileBytes + (SELECT ? kListBytes : 0);
  auto kern = periodic ? knn_tile_kernel<true, SELECT>
                       : knn_tile_kernel<false, SELECT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(npieces, kGroups), kThreads, bytes, stream>>>(
      q, qstride, piece_q0, piece_qn, piece_pid, run_start, run_len, nruns,
      xyz, xstride, box, out_d2, out_slot, width, row_base);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return the first CUDA error of the launch (0 = launched).
extern "C" int knn_dist(const float* q, long long qstride, const int* piece_q0,
                        const int* piece_qn, const int* piece_pid,
                        int npieces, const int* run_start, const int* run_len,
                        int nruns, const float* xyz, long long xstride,
                        int periodic, float L0, float L1, float L2,
                        float iL0, float iL1, float iL2, float* out,
                        int ncand, int row_base, cudaStream_t stream) {
  const Box box = {{L0, L1, L2}, {iL0, iL1, iL2}};
  return launch<false>(q, qstride, piece_q0, piece_qn, piece_pid, npieces,
                       run_start, run_len, nruns, xyz, xstride, periodic, box,
                       out, nullptr, ncand, row_base, stream);
}

extern "C" int knn_select(const float* q, long long qstride,
                          const int* piece_q0, const int* piece_qn,
                          const int* piece_pid, int npieces,
                          const int* run_start, const int* run_len, int nruns,
                          const float* xyz, long long xstride, int periodic,
                          float L0, float L1, float L2, float iL0, float iL1,
                          float iL2, float* out_d2, int* out_slot, int k,
                          int row_base, cudaStream_t stream) {
  if (k > kSelectMax) return static_cast<int>(cudaErrorInvalidValue);
  const Box box = {{L0, L1, L2}, {iL0, iL1, iL2}};
  return launch<true>(q, qstride, piece_q0, piece_qn, piece_pid, npieces,
                      run_start, run_len, nruns, xyz, xstride, periodic, box,
                      out_d2, out_slot, k, row_base, stream);
}
