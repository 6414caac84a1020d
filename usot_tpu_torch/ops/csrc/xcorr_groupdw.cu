// Fused 3-scale GroupDW depthwise cross-correlation for Hopper (sm_90a).
//
// Replaces the TPU kernel usot_tpu/ops/pallas/xcorr_kernel.py::
// xcorr_groupdw_pallas (body _groupdw_multi_kernel). It computes, VALID,
//
//   out[b,m,i,j,c] = sum_{s<3} sum_{u<hk_s, v<wk_s}
//                    x_s[b, i+u, j+v, c] * k_s[b, m, u, v, c]
//
// with x_s (B, hx_s, wx_s, C), k_s (B, M, hk_s, wk_s, C) and out
// (B, M, Ho, Wo, C), all contiguous NHWC (C innermost), f32 or bf16 in,
// f32 accumulation, output in the input type. The three scales share one
// (Ho, Wo); the caller checks that.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 without tensor cores):
// at the tracker's shapes (B=1, C=256, 55 taps, Ho=Wo=25) the bytes win.
// M=7 moves ~7.3 MB in f32 (search maps 2.46 MB, kernels 0.39 MB, output
// 4.48 MB) = ~2.2 us, against 2*55*7*625*256 = 123 MFLOP = ~1.8 us; M=1
// moves ~3.2 MB = ~0.95 us. At B=1 a launch costs more than either.
//
// Design: one thread per output element, c fastest, so a warp's loads of
// x_s[b, i+u, j+v, c..c+31] and k_s[b, m, u, v, c..c+31] are contiguous
// and coalesce; the 55 taps are a loop with the sum in a register.
// Neighbouring (i, j, m) re-read the same search rows, which the L1/L2
// caches serve. Any B, M, C and Wo work: there is no padding.
// Keeping search rows in shared memory across M, tiling and a persistent
// grid are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Scale {
  const void* x;  // (B, hx, wx, C)
  const void* k;  // (B, M, hk, wk, C)
  int hx, wx, hk, wk;
};

struct Params {
  Scale s[3];
  void* out;  // (B, M, Ho, Wo, C)
  int B, M, C, Ho, Wo;
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

template <typename T>
__global__ void __launch_bounds__(256) groupdw_kernel(Params p) {
  const int64_t total = (int64_t)p.B * p.M * p.Ho * p.Wo * p.C;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t C = p.C;
  const int c = (int)(idx % C);
  int64_t r = idx / C;
  const int j = (int)(r % p.Wo);
  r /= p.Wo;
  const int i = (int)(r % p.Ho);
  r /= p.Ho;
  const int m = (int)(r % p.M);
  const int b = (int)(r / p.M);

  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const Scale sc = p.s[s];
    const T* __restrict__ x =
        static_cast<const T*>(sc.x) + (int64_t)b * sc.hx * sc.wx * C + c;
    const T* __restrict__ k = static_cast<const T*>(sc.k) +
                              ((int64_t)b * p.M + m) * sc.hk * sc.wk * C + c;
    for (int u = 0; u < sc.hk; ++u) {
      const T* xrow = x + ((int64_t)(i + u) * sc.wx + j) * C;
      const T* krow = k + (int64_t)u * sc.wk * C;
      for (int v = 0; v < sc.wk; ++v) {
        acc = fmaf(to_float(xrow[v * C]), to_float(krow[v * C]), acc);
      }
    }
  }
  static_cast<T*>(p.out)[idx] = from_float<T>(acc);
}

}  // namespace

// dims: B, M, C, Ho, Wo, then (hx, wx, hk, wk) for each of the 3 scales.
// dtype: 0 = float32, 1 = bfloat16. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int usot_xcorr_groupdw(int dtype, const void* x0, const void* x1,
                                  const void* x2, const void* k0,
                                  const void* k1, const void* k2, void* out,
                                  const int* dims, void* stream) {
  Params p;
  const void* xs[3] = {x0, x1, x2};
  const void* ks[3] = {k0, k1, k2};
  p.B = dims[0];
  p.M = dims[1];
  p.C = dims[2];
  p.Ho = dims[3];
  p.Wo = dims[4];
  for (int s = 0; s < 3; ++s) {
    p.s[s].x = xs[s];
    p.s[s].k = ks[s];
    p.s[s].hx = dims[5 + 4 * s];
    p.s[s].wx = dims[6 + 4 * s];
    p.s[s].hk = dims[7 + 4 * s];
    p.s[s].wk = dims[8 + 4 * s];
  }
  p.out = out;
  const int64_t total = (int64_t)p.B * p.M * p.Ho * p.Wo * p.C;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    groupdw_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(p);
  } else if (dtype == 1) {
    groupdw_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
