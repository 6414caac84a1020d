// Tiled depthwise cross-correlation for Hopper (sm_90a): the one
// accumulation routine behind K1 (xcorr_groupdw.cu) and K2/K3
// (xcorr_depthwise.cu), templated on the element type (f32, bf16) and on
// the number of scales NS (3 for K1, 1 for K2 and K3). It computes, VALID,
//
//   out[b,m,i,j,c] = sum_{s<NS} sum_{u<hk_s, v<wk_s}
//                    x_s[b, i+u, j+v, c] * k_s[b, m, u, v, c]
//
// with x_s (B, hx_s, wx_s, C), k_s (B, M, hk_s, wk_s, C) and out
// (B, M, Ho, Wo, C), all contiguous NHWC (C innermost), f32 or bf16 in,
// f32 accumulation in the order s, u, v, output in the input type. The
// scales share one (Ho, Wo); the caller checks that.
//
// What bounds it. A correlation has no reduction over channels, so the
// FMAs run on the FP32 units (TF32 would break the 1e-4 parity). At the
// production shapes the bytes bound the function (K1 at B=32, M=7, f32:
// 235 MB, 70 us at 3.35 TB/s, against 2.0 G FMAs, 59 us at 67 TFLOP/s),
// but a kernel that loads both operands of every FMA is bound by its
// loads long before either: an SM issues four 32-lane FMAs per clock and
// reads one 32-lane word of shared memory or L1 per clock. So the design
// keeps the operands of many FMAs in registers and every operand in
// shared memory:
//
// * Block: (b, a slab of 32 channels, a band of `band` output rows, a
//   tile of up to kTileCols output columns, a group of `mper` kernels).
//   It copies its search rows of every scale, (band + hk_s - 1) rows of
//   the tile's columns plus wk_s - 1, and the taps of its mper kernels,
//   32 channels each, into shared memory once (16-byte cp.async where C
//   and the pointers allow it, else element by element). Every kernel m
//   and every row of the band reads the search rows there: the reuse the
//   TPU kernel got by keeping the search block resident across its M
//   grid axis. Taps in shared memory rather than read through L1 cost no
//   64-bit address arithmetic and a shorter wait per tap row.
// * Warp: one (m, group of kRows output rows, strip of kStrip outputs
//   along j) at a time, kWarps warps walking the block's items; lane =
//   channel, so a warp's shared-memory reads are 32 consecutive words
//   (no bank conflict) and its global reads and writes whole 128-byte
//   lines (64 in bf16).
// * Thread: kRows x kStrip f32 accumulators in registers. It loads each
//   search row's kStrip + wk - 1 values once and uses them for every
//   output row of its group that the row feeds, with that row's wk taps:
//   per search row 13 + 2 x 5 loads for 90 FMAs at 5-wide taps, 0.26
//   loads per FMA, against 2 in a one-thread-per-output design.
// * Grid: shared memory is sized for two blocks per SM (thinner bands
//   down to kRows rows, then fewer kernels per block); then the host
//   splits along M and into thinner bands until there are two blocks per
//   SM, so that B=1 fills the card too.
//
// Register windows need compile-time widths: kernels are at most
// kMaxTap x kMaxTap (8 x 8; every shape of the JAX package and its tests
// is 5, 3, 4 or 1 wide), and the wrapper raises beyond that. Ragged
// edges in C, Ho, Wo and M are masked here; the wrapper pads nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace usot_xcorr {

constexpr int kLanes = 32;            // channels per slab, one per lane
constexpr int kStrip = 9;             // outputs along j per thread
constexpr int kRows = 2;              // output rows per thread
constexpr int kTileCols = 4 * kStrip; // output columns per block (36)
constexpr int kMaxTap = 8;            // largest kernel height and width
constexpr int kMaxBand = 8;           // output rows per block, at most
constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;
// Two blocks fit on an SM (228 KB, 1 KB reserved per block) below this.
constexpr size_t kSmemPreferred = 112 * 1024;
constexpr int kMaxDevices = 64;

struct Scale {
  const void* x;  // (B, hx, wx, C)
  const void* k;  // (B, M, hk, wk, C)
  int hx, wx, hk, wk;
};

struct Params {
  Scale s[3];
  void* out;  // (B, M, Ho, Wo, C)
  int B, M, C, Ho, Wo;
  // set by launch_tile(): the block decomposition
  int nslabs, band, nbands, ntiles, tile, mper, mgroups;
  int vec;        // 16-byte cp.async for the search rows
  int sw[3];      // shared-memory row width of each scale, in pixels
  int off[3];     // element offset of each scale's rows in shared memory
  int koff[3];    // element offset of each scale's taps in shared memory
  int kvec;       // 16-byte cp.async for the taps
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Copies nrows x ncols pixels (rows of a search map, or the taps of
// nrows kernels) of 32 channels from c0, row stride wx pixels in global
// memory and sw in shared memory, into dst. Lanes past C are left
// unwritten: nothing reads them into a stored output.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int nrows,
                                      int ncols, int wx, int sw, int C,
                                      int c0, bool vec) {
  const int npix = nrows * ncols;
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte copy
    constexpr int kChunks = kLanes / kPer;
    const int valid = min(kChunks, (C - c0) / kPer);  // C % kPer == 0
    for (int q = threadIdx.x; q < npix * kChunks; q += blockDim.x) {
      const int pix = q / kChunks, ch = q - pix * kChunks;
      const int r = pix / ncols, col = pix - r * ncols;
      if (ch < valid)
        cp_async16(dst + (r * sw + col) * kLanes + ch * kPer,
                   src + ((int64_t)r * wx + col) * C + ch * kPer);
    }
  } else {
    const int valid = min(kLanes, C - c0);
    for (int q = threadIdx.x; q < npix * kLanes; q += blockDim.x) {
      const int pix = q / kLanes, lane = q - pix * kLanes;
      const int r = pix / ncols, col = pix - r * ncols;
      if (lane < valid)
        dst[(r * sw + col) * kLanes + lane] =
            src[((int64_t)r * wx + col) * C + lane];
    }
  }
}

// acc[t][jj] += sum_{u<hk, v<WK} xs[t + u][jj + v] * k[u][v] for one
// lane and rows t < rt: xs points at the lane's word of the strip's first
// pixel of the group's first row in shared memory (row stride xstride
// elements), k at the lane's word of tap (0, 0) in shared memory. Rows
// are padded to whole strips, so the window needs no bounds check: the
// columns past the staged ones only reach outputs that are not stored.
// Each search row is loaded once for the up to kRows output rows it
// feeds, each tap row once per output row.
template <int WK, typename T>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][kStrip],
                                           const T* xs, int xstride,
                                           const T* k, int hk, int rt) {
  constexpr int kWin = kStrip + WK - 1;
  for (int r = 0; r < rt + hk - 1; ++r) {
    float xv[kWin];
#pragma unroll
    for (int t = 0; t < kWin; ++t)
      xv[t] = to_float(xs[r * xstride + t * kLanes]);
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int u = r - t;  // tap row that search row r gives output row t
      if (t < rt && u >= 0 && u < hk) {
        float kv[WK];
#pragma unroll
        for (int v = 0; v < WK; ++v)
          kv[v] = to_float(k[(u * WK + v) * kLanes]);
#pragma unroll
        for (int jj = 0; jj < kStrip; ++jj) {
#pragma unroll
          for (int v = 0; v < WK; ++v)
            acc[t][jj] = fmaf(xv[jj + v], kv[v], acc[t][jj]);
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void accumulate_scale(
    float (&acc)[kRows][kStrip], const T* xs, int xstride, const T* k,
    int hk, int wk, int rt) {
  switch (wk) {
    case 1: accumulate<1>(acc, xs, xstride, k, hk, rt); break;
    case 2: accumulate<2>(acc, xs, xstride, k, hk, rt); break;
    case 3: accumulate<3>(acc, xs, xstride, k, hk, rt); break;
    case 4: accumulate<4>(acc, xs, xstride, k, hk, rt); break;
    case 5: accumulate<5>(acc, xs, xstride, k, hk, rt); break;
    case 6: accumulate<6>(acc, xs, xstride, k, hk, rt); break;
    case 7: accumulate<7>(acc, xs, xstride, k, hk, rt); break;
    default: accumulate<8>(acc, xs, xstride, k, hk, rt); break;
  }
}

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads, 2) xcorr_tile_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  int bid = blockIdx.x;
  const int mg = bid % p.mgroups;
  bid /= p.mgroups;
  const int tile = bid % p.ntiles;
  bid /= p.ntiles;
  const int band = bid % p.nbands;
  bid /= p.nbands;
  const int slab = bid % p.nslabs;
  const int b = bid / p.nslabs;
  const int c0 = slab * kLanes;
  const int i0 = band * p.band, rows = min(p.band, p.Ho - i0);
  const int jc0 = tile * p.tile, cols = min(p.tile, p.Wo - jc0);
  const int m0 = mg * p.mper, mcount = min(p.mper, p.M - m0);

#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const Scale& sc = p.s[s];
    const T* src = static_cast<const T*>(sc.x) +
                   (((int64_t)b * sc.hx + i0) * sc.wx + jc0) * p.C + c0;
    stage<T>(smem + p.off[s], src, rows + sc.hk - 1, cols + sc.wk - 1,
             sc.wx, p.sw[s], p.C, c0, p.vec != 0);
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const Scale& sc = p.s[s];
    const int taps = sc.hk * sc.wk;
    const T* src = static_cast<const T*>(sc.k) +
                   ((int64_t)b * p.M + m0) * taps * p.C + c0;
    stage<T>(smem + p.koff[s], src, mcount, taps, taps, taps, p.C, c0,
             p.kvec != 0);
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = c0 + lane;
  const bool live = c < p.C;
  const int nstrips = (cols + kStrip - 1) / kStrip;
  const int ngroups = (rows + kRows - 1) / kRows;
  const int items = mcount * ngroups * nstrips;
  for (int it = warp; it < items; it += kWarps) {
    const int strip = it % nstrips;
    const int t = it / nstrips;
    const int ii = (t % ngroups) * kRows;  // first row of the group
    const int rt = min(kRows, rows - ii);
    const int m = m0 + t / ngroups;
    const int jt = strip * kStrip;  // column of the strip in the tile
    float acc[kRows][kStrip];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int jj = 0; jj < kStrip; ++jj) acc[r][jj] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const Scale& sc = p.s[s];
      const T* xs = smem + p.off[s] + (ii * p.sw[s] + jt) * kLanes + lane;
      const T* k =
          smem + p.koff[s] + (m - m0) * sc.hk * sc.wk * kLanes + lane;
      accumulate_scale<T>(acc, xs, p.sw[s] * kLanes, k, sc.hk, sc.wk, rt);
    }
    if (live) {
      const int n = min(kStrip, cols - jt);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rt) {
          T* o = static_cast<T*>(p.out) +
                 ((((int64_t)b * p.M + m) * p.Ho + i0 + ii + r) * p.Wo + jc0 +
                  jt) * p.C + c;
#pragma unroll
          for (int jj = 0; jj < kStrip; ++jj)
            if (jj < n) o[(int64_t)jj * p.C] = from_float<T>(acc[r][jj]);
        }
      }
    }
  }
}

inline int device_attribute(cudaDeviceAttr attr, int dev, int* cache) {
  if (cache[dev] == 0) cudaDeviceGetAttribute(&cache[dev], attr, dev);
  return cache[dev];
}

// Sizes the grid for p, sets the instantiation's shared-memory limit on
// its first launch on a device, and launches on `stream` without
// synchronising. Returns cudaGetLastError() (0 on success).
template <typename T, int NS>
int launch_tile(Params p, cudaStream_t stream) {
  if ((int64_t)p.B * p.M * p.C * p.Ho * p.Wo == 0) return 0;
  for (int s = 0; s < NS; ++s)
    if (p.s[s].hk < 1 || p.s[s].hk > kMaxTap || p.s[s].wk < 1 ||
        p.s[s].wk > kMaxTap)
      return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static int sms[kMaxDevices], optin[kMaxDevices];
  static bool attr_set[kMaxDevices];  // one per instantiation
  const int n_sm = device_attribute(cudaDevAttrMultiProcessorCount, dev, sms);
  const int max_smem = device_attribute(
      cudaDevAttrMaxSharedMemoryPerBlockOptin, dev, optin);
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(xcorr_tile_kernel<T, NS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }

  p.tile = std::min(kTileCols, p.Wo);
  p.ntiles = (p.Wo + p.tile - 1) / p.tile;
  const int padded = (p.tile + kStrip - 1) / kStrip * kStrip;
  p.nslabs = (p.C + kLanes - 1) / kLanes;
  auto smem_bytes = [&](int band, int mper) {
    size_t n = 0;
    for (int s = 0; s < NS; ++s)
      n += (size_t)(band + p.s[s].hk - 1) * (padded + p.s[s].wk - 1) +
           (size_t)mper * p.s[s].hk * p.s[s].wk;
    return n * kLanes * sizeof(T);
  };
  // Fit two blocks on an SM: thinner bands down to kRows rows, then fewer
  // kernels per block, then thinner bands still.
  int band = std::min(kMaxBand, p.Ho), mper = p.M;
  while (smem_bytes(band, mper) > kSmemPreferred) {
    if (band > std::min(kRows, p.Ho)) --band;
    else if (mper > 1) --mper;
    else if (band > 1) --band;
    else break;
  }
  int nbands = (p.Ho + band - 1) / band;
  int mgroups = (p.M + mper - 1) / mper;
  // fill the card: split along M, then into thinner bands
  const int64_t target = 2LL * n_sm;
  int64_t blocks = (int64_t)p.B * p.nslabs * p.ntiles * nbands;
  if (blocks * mgroups < target)
    mgroups = (int)std::min<int64_t>(p.M, (target + blocks - 1) / blocks);
  blocks *= mgroups;
  if (blocks < target)
    nbands = (int)std::min<int64_t>(p.Ho, nbands * ((target + blocks - 1) / blocks));
  p.band = (p.Ho + nbands - 1) / nbands;  // even bands
  p.nbands = (p.Ho + p.band - 1) / p.band;
  p.mper = (p.M + mgroups - 1) / mgroups;  // even groups
  p.mgroups = (p.M + p.mper - 1) / p.mper;
  const size_t smem = smem_bytes(p.band, p.mper);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  int off = 0;
  for (int s = 0; s < NS; ++s) {
    p.sw[s] = padded + p.s[s].wk - 1;
    p.off[s] = off;
    off += (p.band + p.s[s].hk - 1) * p.sw[s] * kLanes;
  }
  for (int s = 0; s < NS; ++s) {
    p.koff[s] = off;
    off += p.mper * p.s[s].hk * p.s[s].wk * kLanes;
  }
  constexpr int kPer = 16 / sizeof(T);
  p.vec = p.C % kPer == 0;
  p.kvec = p.vec;
  for (int s = 0; s < NS; ++s) {
    p.vec = p.vec && reinterpret_cast<uintptr_t>(p.s[s].x) % 16 == 0;
    p.kvec = p.kvec && reinterpret_cast<uintptr_t>(p.s[s].k) % 16 == 0;
  }
  const int64_t grid =
      (int64_t)p.B * p.nslabs * p.nbands * p.ntiles * p.mgroups;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  xcorr_tile_kernel<T, NS><<<(unsigned)grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.
template <int NS>
int launch(int dtype, const Params& p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tile<float, NS>(p, st);
  if (dtype == 1) return launch_tile<__nv_bfloat16, NS>(p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace usot_xcorr
