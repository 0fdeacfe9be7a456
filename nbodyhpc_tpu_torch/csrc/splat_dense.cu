// Dense large-radius pass of the volume render: deposits every row above the
// tile engine's last bucket (15 px) over its own footprint, straight into
// the logical (gx, gy, gz) float32 volume (C order, z fastest).
//
// Replaces no TPU kernel: nbodyhpc_tpu/ops/splat_dense.py is plain XLA, one
// static F^3 window per row with F from the largest radius of the batch. Its
// plain twin in this package (ops/splat_dense.py::dense_reference) evaluates
// rows in chunks of that window from a host loop; at 30 px radii that is
// ~4e5 voxels a row and ~8e4 chunks a render. Here every row is evaluated on
// its own footprint; the host reads one number between the launches (the
// length of the tile lists) and loops over nothing.
//
// Bound: the voxels the rows' spheres hold. The least device-memory work is
// to read each row once (20 bytes) and write each voxel it covers once (4
// bytes), but the spheres overlap: a clustered 256^3 snapshot rendered into
// 1024^3 puts ~1.4e10 sphere voxels on 1.07e9 grid voxels. So the design
// keeps the sums out of device memory:
//
// 1. Binning (splat_dense_count, splat_dense_fill). The volume is cut into
//    tiles of kTX x kTY x kTZ voxels. bin_count counts, per tile, the rows
//    whose window [floor(p) - R, floor(p) + R] (R = ceil(rp) + 3, the
//    window of ops/splat.py::required_halfwidth) meets it inside the grid;
//    bin_scan turns the counts into offsets, the last the lists' length,
//    which the wrapper reads to allocate them; bin_fill writes each row's
//    index into every tile it meets. The order inside a tile is the
//    atomics'.
// 2. Deposit (splat_dense). One block per tile holds the tile in shared
//    memory. Each of its 256 threads owns one (x, y) column of the tile and
//    walks the tile's rows; for a row that reaches its column it walks the
//    column's z voxels inside the tile and adds each non-zero value with a
//    plain shared-memory add: no other thread writes the column, and it
//    adds the rows in the tile list's order. Then the block adds the tile
//    into the volume once, with plain loads and stores: no other block owns
//    those voxels, and the deposits of the kernel buckets ran before on the
//    same stream.
// 3. Interior runs and the shell, without the S^3 loop. A voxel is interior
//    (count S^3, value exactly the row's factor) when max az < rab_lo, the
//    first test of splat_common.h's subcell count. Along a column dz = pz -
//    vz falls with vz (rounded subtraction is monotone), and each az = (dz -
//    u)^2 falls and then rises, so the interior voxels form one interval of
//    slices. A guess from sqrt(rab_lo) and exact tests at its ends
//    (interior_run, usually 2-4 tests) find it; the gates hold on one
//    interval of slices too (splat_deposit.cu, point 1), so when they hold
//    at both ends of the run, each of its voxels gets the factor by a plain
//    add, with neither count nor gate. The walk's other voxels, the shell,
//    take the per-voxel subcell count and gates; so does the
//    whole walk when the run is empty (rab_lo <= 0, no voxel passes), its
//    ends are not reached, or a gate fails at an end. A column with rab_hi
//    <= 0 counts 0 everywhere (az >= 0), and along a column only the slices
//    |vz - floor(pz)| < ceil(sqrt(rab_hi)) + 3 can count more than 0 (|dz -
//    u| >= that less 2 outside), so the walk is cut to them. With a counts
//    buffer, the launch adds the run voxels and the shell voxels into it,
//    one atomic each a block.
//
// Exactness: a voxel gets w / (4/3 pi rp^3) * (count / S^3) where the
// oracle's gates pass (ops/splat.py::footprint_values: the gl_ClipDistance
// cull |z_off| <= rp + 1 and the coverage square of half-side ceil(plane_r)
// + 1), each term in the oracle's float32 order; the per-row factor comes
// from the wrapper, computed by footprint_values's own expression. A
// sub-pixel row (rp < 0.5) adds its raw weight to the voxel holding it, z in
// (vz, vz + 1]. Every formula is in absolute voxel coordinates, so a row's
// window cut by the grid's faces covers exactly footprint and grid, as the
// plain pass's clamped window does. A run voxel gets v, which is v * 1.0f,
// the term its count gives. Only the order of the additions differs from
// the plain pass's. Build with --fmad=false (see splat_common.h).
//
// Rows: pos float32 [n][3] in pixel units, rad float32 [n] (pixel radius),
// val float32 [n] (the per-row factor: w / (4/3 pi rp^3), or w for a
// sub-pixel row). A row with val == 0 adds nothing and is not binned.
#include <cuda_runtime.h>

#include "splat_common.h"

namespace {

using splat::kMaxS;

constexpr int kTX = 16, kTY = 16, kTZ = 64;  // tile extent in voxels
constexpr int kZS = kTZ + 1;  // a column's stride in shared memory (banks)
constexpr int kThreads = kTX * kTY;  // one thread per (x, y) column
constexpr int kBinThreads = 256;
constexpr int kScanThreads = 1024;
constexpr size_t kTileBytes = sizeof(float) * kTX * kTY * kZS;

// The tiles [t0, t1] on one axis that the window [floor(p) - R, floor(p) + R]
// meets inside [0, g); false when it misses the grid.
__device__ __forceinline__ bool axis_tiles(float p, int R, int g, int T,
                                           int& t0, int& t1) {
  const float f = floorf(p);
  if (!(f + static_cast<float>(R) >= 0.0f &&
        f - static_cast<float>(R) <= static_cast<float>(g - 1)))
    return false;
  const int fi = static_cast<int>(f);
  t0 = max(fi - R, 0) / T;
  t1 = min(fi + R, g - 1) / T;
  return true;
}

struct TileBox {
  int x0, x1, y0, y1, z0, z1;
};

__device__ __forceinline__ bool row_tiles(const float* __restrict__ pos,
                                          const float* __restrict__ rad,
                                          const float* __restrict__ val,
                                          int i, int gx, int gy, int gz,
                                          TileBox& b) {
  if (val[i] == 0.0f) return false;
  const int R = static_cast<int>(ceilf(fmaxf(rad[i], 0.0f))) + 3;
  return axis_tiles(pos[3 * i], R, gx, kTX, b.x0, b.x1) &&
         axis_tiles(pos[3 * i + 1], R, gy, kTY, b.y0, b.y1) &&
         axis_tiles(pos[3 * i + 2], R, gz, kTZ, b.z0, b.z1);
}

__global__ void __launch_bounds__(kBinThreads)
bin_count(const float* __restrict__ pos, const float* __restrict__ rad,
          const float* __restrict__ val, int n, int gx, int gy, int gz,
          int nty, int ntz, int* __restrict__ cnt) {
  const int i = blockIdx.x * kBinThreads + threadIdx.x;
  TileBox b;
  if (i >= n || !row_tiles(pos, rad, val, i, gx, gy, gz, b)) return;
  for (int tx = b.x0; tx <= b.x1; ++tx)
    for (int ty = b.y0; ty <= b.y1; ++ty)
      for (int tz = b.z0; tz <= b.z1; ++tz)
        atomicAdd(cnt + (tx * nty + ty) * ntz + tz, 1);
}

// off[t] = sum of cnt[0..t), off[nt] the total; one block.
__global__ void __launch_bounds__(kScanThreads)
bin_scan(const int* __restrict__ cnt, long long* __restrict__ off, int nt) {
  __shared__ long long part[kScanThreads];
  const int per = (nt + kScanThreads - 1) / kScanThreads;
  const int a = min(static_cast<int>(threadIdx.x) * per, nt);
  const int b = min(a + per, nt);
  long long s = 0;
  for (int t = a; t < b; ++t) s += cnt[t];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {
    const long long v = static_cast<int>(threadIdx.x) >= o ? part[threadIdx.x - o] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  long long base = part[threadIdx.x] - s;
  for (int t = a; t < b; ++t) {
    off[t] = base;
    base += cnt[t];
  }
  if (threadIdx.x == kScanThreads - 1) off[nt] = part[kScanThreads - 1];
}

__global__ void __launch_bounds__(kBinThreads)
bin_fill(const float* __restrict__ pos, const float* __restrict__ rad,
         const float* __restrict__ val, int n, int gx, int gy, int gz,
         int nty, int ntz, const long long* __restrict__ off,
         int* __restrict__ cursor, int* __restrict__ list) {
  const int i = blockIdx.x * kBinThreads + threadIdx.x;
  TileBox b;
  if (i >= n || !row_tiles(pos, rad, val, i, gx, gy, gz, b)) return;
  for (int tx = b.x0; tx <= b.x1; ++tx)
    for (int ty = b.y0; ty <= b.y1; ++ty)
      for (int tz = b.z0; tz <= b.z1; ++tz) {
        const int t = (tx * nty + ty) * ntz + tz;
        list[off[t] + atomicAdd(cursor + t, 1)] = i;
      }
}

// The exact tests an end of a column's interior run may take past its guess.
constexpr int kEndSteps = 3;

// Moves b, a slice of [zl, zh], to the end of the column's interior run on
// the side dir (-1: the run's least slice in [zl, zh], +1: its greatest):
// interior at b, and b the window's end on that side or the next slice out
// not interior. The interior slices form one interval (see the header's
// point 3), so that b is the end. False when kEndSteps more tests do not
// reach it.
__device__ __forceinline__ bool run_end(float pz, float ulo, float uhi,
                                        float rab_lo, int zl, int zh, int dir,
                                        int& b) {
  const auto inside = [&](int vz) {
    return splat::interior(ulo, uhi, rab_lo, pz - static_cast<float>(vz));
  };
  const int lim = dir < 0 ? zl : zh;
  if (inside(b)) {
    for (int k = 0; k < kEndSteps; ++k) {
      if (b == lim || !inside(b + dir)) return true;
      b += dir;
    }
    return false;
  }
  for (int k = 0; k < kEndSteps; ++k) {
    b -= dir;
    if (b < zl || b > zh) return false;
    if (inside(b)) return true;
  }
  return false;
}

// The column's interior run inside [zl, zh] (rab_lo > 0): [ra, rb], the
// slices whose subcell count is S^3. The guess solves |pz - vz - u| < s,
// s = sqrt(rab_lo), for the first and last subcell offsets; run_end moves
// each end onto the exact test. False when the guess misses the window or
// an end is not reached: the caller then counts every slice.
__device__ __forceinline__ bool interior_run(float pz, float ulo, float uhi,
                                             float rab_lo, int zl, int zh,
                                             int& ra, int& rb) {
  const float s = sqrtf(rab_lo);
  ra = max(static_cast<int>(floorf((pz - ulo) - s)) + 1, zl);
  rb = min(static_cast<int>(ceilf((pz - uhi) + s)) - 1, zh);
  return ra <= rb && run_end(pz, ulo, uhi, rab_lo, zl, zh, -1, ra) &&
         run_end(pz, ulo, uhi, rab_lo, zl, zh, 1, rb);
}

// Adds the block's totals a and b into counts[0] and counts[1], one atomic
// each. Every thread of the block calls it.
__device__ __forceinline__ void add_counts(long long a, long long b,
                                           unsigned long long* counts) {
  __shared__ long long part[2][kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      part[0][0] += part[0][w];
      part[1][0] += part[1][w];
    }
    atomicAdd(counts, static_cast<unsigned long long>(part[0][0]));
    atomicAdd(counts + 1, static_cast<unsigned long long>(part[1][0]));
  }
}

template <int SC>  // SC = compile-time subsample, 0 = runtime s_rt
__global__ void __launch_bounds__(kThreads)
dense_kernel(const float* __restrict__ pos, const float* __restrict__ rad,
             const float* __restrict__ val, const long long* __restrict__ off,
             const int* __restrict__ list, int s_rt,
             float* __restrict__ vol, int gx, int gy, int gz, int nty,
             int ntz, unsigned long long* __restrict__ counts) {
  extern __shared__ float tile[];  // [kTX][kTY][kZS]
  const int t = blockIdx.x;
  const long long j0 = off[t], j1 = off[t + 1];
  if (j0 >= j1) return;
  const int tz = t % ntz;
  const int ty = (t / ntz) % nty;
  const int tx = t / (ntz * nty);
  const int x0 = tx * kTX, y0 = ty * kTY, z0 = tz * kTZ;
  for (int k = threadIdx.x; k < kTX * kTY * kZS; k += kThreads)
    tile[k] = 0.0f;
  __syncthreads();

  constexpr int kS = splat::kSlots<SC>;
  const int S = SC > 0 ? SC : s_rt;
  const int S3 = S * S * S;
  const float s3 = static_cast<float>(S3);
  float u[kS];
  splat::subcell_offsets<SC>(u, S);
  const float ulo = u[0], uhi = u[S - 1];

  // this thread's column: each warp a 4 x 8 patch of the 16 x 16 columns,
  // so its lanes meet a sphere with similar z extents
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lx = (warp >> 1) * 4 + (lane >> 3);
  const int ly = (warp & 1) * 8 + (lane & 7);
  const int vx = x0 + lx, vy = y0 + ly;
  float* col = tile + (lx * kTY + ly) * kZS;  // col[vz - z0], this thread's
  const int za = z0, zb = min(z0 + kTZ, gz) - 1;
  const float vxf = static_cast<float>(vx), vyf = static_cast<float>(vy);
  long long run_voxels = 0, shell_voxels = 0;

  if (vx < gx && vy < gy) {
    for (long long j = j0; j < j1; ++j) {
      const int i = list[j];
      const float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
      const float r = rad[i];
      const int R = static_cast<int>(ceilf(fmaxf(r, 0.0f))) + 3;
      const int fx = static_cast<int>(floorf(px));
      const int fy = static_cast<int>(floorf(py));
      if (vx < fx - R || vx > fx + R || vy < fy - R || vy > fy + R) continue;
      const float v = val[i];
      const int fz = static_cast<int>(floorf(pz));
      if (r < 0.5f) {
        // sub-pixel: the voxel holding it, z in (vz, vz + 1]
        const int vz = static_cast<int>(ceilf(pz)) - 1;
        const float vzf = static_cast<float>(vz);
        if (vx == fx && vy == fy && vz >= za && vz <= zb && pz > vzf &&
            pz <= vzf + 1.0f)
          col[vz - z0] += v;
        continue;
      }
      const float r2 = r * r;
      float ax[kS], ay[kS], rab_lo, rab_hi;
      splat::column_rows<SC>(u, S, px - vxf, py - vyf, r2, ax, ay, rab_lo,
                             rab_hi);
      if (!(rab_hi > 0.0f)) continue;  // no subcell of the column inside
      const float cx = (vxf + 0.5f) - px;
      const float cy = (vyf + 0.5f) - py;
      const int ze = static_cast<int>(ceilf(sqrtf(rab_hi))) + 3;
      const int zl = max(fz - min(R, ze), za);
      const int zh = min(fz + min(R, ze), zb);
      // the interior run [ra, rb]: count S^3, so each voxel gets v * 1.0f,
      // where the gates hold at both ends (then on all of it)
      int ra = zh + 1, rb = zh;
      if (rab_lo > 0.0f) {
        int a, b;
        if (interior_run(pz, ulo, uhi, rab_lo, zl, zh, a, b) &&
            splat::gated(cx, cy, pz, r, r2, a) &&
            splat::gated(cx, cy, pz, r, r2, b)) {
          ra = a;
          rb = b;
        }
      }
      for (int vz = ra; vz <= rb; ++vz) col[vz - z0] += v;
      // the shell: the walk's other slices, [zl, ra) and (rb, zh], counted
      const int nlo = ra - zl;
      const int nshell = (zh - zl + 1) - (rb - ra + 1);
      run_voxels += rb - ra + 1;
      shell_voxels += max(nshell, 0);
      for (int k = 0; k < nshell; ++k) {
        const int vz = k < nlo ? zl + k : rb + 1 + (k - nlo);
        const int count = splat::subcell_count<SC>(
            u, S, ax, ay, r2, rab_lo, rab_hi, pz - static_cast<float>(vz));
        if (count == 0) continue;
        if (!splat::gated(cx, cy, pz, r, r2, vz)) continue;
        // count / S^3 is 1.0f exactly for an interior voxel
        col[vz - z0] +=
            v * (count == S3 ? 1.0f : static_cast<float>(count) / s3);
      }
    }
  }
  __syncthreads();

  // the tile into the volume: consecutive threads on consecutive z
  for (int k = threadIdx.x; k < kTX * kTY * kTZ; k += kThreads) {
    const int lz = k % kTZ;
    const int c = k / kTZ;
    const int x = x0 + c / kTY, y = y0 + c % kTY, z = z0 + lz;
    const float s = tile[c * kZS + lz];
    if (x < gx && y < gy && z < gz && s != 0.0f)
      vol[(static_cast<long long>(x) * gy + y) * gz + z] += s;
  }
  if (counts != nullptr) add_counts(run_voxels, shell_voxels, counts);
}

int num_tiles(int g, int T) { return (g + T - 1) / T; }

}  // namespace

// The tiles of a (gx, gy, gz) grid (x-major, z fastest): the length of the
// count and cursor arrays below; the offsets hold one more. 0 for an empty
// grid.
extern "C" int splat_dense_tiles(int gx, int gy, int gz) {
  if (gx <= 0 || gy <= 0 || gz <= 0) return 0;
  return num_tiles(gx, kTX) * num_tiles(gy, kTY) * num_tiles(gz, kTZ);
}

// Counts the rows of each tile: cnt int32 [nt], off int64 [nt + 1] (nt =
// splat_dense_tiles(gx, gy, gz); off[nt] the lists' length).
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int splat_dense_count(const float* pos, const float* rad,
                                 const float* val, int n, int gx, int gy,
                                 int gz, int* cnt, long long* off,
                                 cudaStream_t stream) {
  if (n <= 0 || gx <= 0 || gy <= 0 || gz <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nty = num_tiles(gy, kTY), ntz = num_tiles(gz, kTZ);
  const int nt = num_tiles(gx, kTX) * nty * ntz;
  cudaMemsetAsync(cnt, 0, sizeof(int) * nt, stream);
  bin_count<<<(n + kBinThreads - 1) / kBinThreads, kBinThreads, 0, stream>>>(
      pos, rad, val, n, gx, gy, gz, nty, ntz, cnt);
  bin_scan<<<1, kScanThreads, 0, stream>>>(cnt, off, nt);
  return static_cast<int>(cudaGetLastError());
}

// Writes each row's index into the lists of the tiles it meets: list int32
// [off[nt]], cursor int32 [nt] scratch. Returns cudaGetLastError().
extern "C" int splat_dense_fill(const float* pos, const float* rad,
                                const float* val, int n, int gx, int gy,
                                int gz, const long long* off, int* cursor,
                                int* list, cudaStream_t stream) {
  if (n <= 0 || gx <= 0 || gy <= 0 || gz <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nty = num_tiles(gy, kTY), ntz = num_tiles(gz, kTZ);
  const int nt = num_tiles(gx, kTX) * nty * ntz;
  cudaMemsetAsync(cursor, 0, sizeof(int) * nt, stream);
  bin_fill<<<(n + kBinThreads - 1) / kBinThreads, kBinThreads, 0, stream>>>(
      pos, rad, val, n, gx, gy, gz, nty, ntz, off, cursor, list);
  return static_cast<int>(cudaGetLastError());
}

// Deposits the binned rows into vol (gx, gy, gz), adding to what it holds.
// counts: null, or int64 [2] to which the launch adds the voxels its
// interior runs added and the voxels it counted (the shells).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int splat_dense(const float* pos, const float* rad,
                           const float* val, const long long* off,
                           const int* list, int S, float* vol, int gx, int gy,
                           int gz, long long* counts, cudaStream_t stream) {
  if (S < 1 || S > kMaxS || gx <= 0 || gy <= 0 || gz <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nty = num_tiles(gy, kTY), ntz = num_tiles(gz, kTZ);
  const int nt = num_tiles(gx, kTX) * nty * ntz;
  auto* cnt = reinterpret_cast<unsigned long long*>(counts);
  if (S == 4) {
    cudaFuncSetAttribute(dense_kernel<4>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kTileBytes));
    dense_kernel<4><<<nt, kThreads, kTileBytes, stream>>>(
        pos, rad, val, off, list, S, vol, gx, gy, gz, nty, ntz, cnt);
  } else {
    cudaFuncSetAttribute(dense_kernel<0>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kTileBytes));
    dense_kernel<0><<<nt, kThreads, kTileBytes, stream>>>(
        pos, rad, val, off, list, S, vol, gx, gy, gz, nty, ntz, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
