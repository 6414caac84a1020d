// Single-scale depthwise cross-correlation for Hopper (sm_90a).
//
// Replaces two TPU kernels of usot_tpu/ops/pallas/xcorr_kernel.py, each
// through its own entry point:
//
//   K2 usot_xcorr_depthwise_multi  <- xcorr_depthwise_multi_pallas
//      (body _xcorr_multi_kernel): one search map against M kernels,
//        out[b,m,i,j,c] = sum_{u<hk, v<wk} x[b,i+u,j+v,c] * k[b,m,u,v,c]
//   K3 usot_xcorr_depthwise        <- xcorr_depthwise_pallas
//      (body _xcorr_kernel): the pairwise correlation, the M = 1 case,
//        out[b,i,j,c]   = sum_{u<hk, v<wk} x[b,i+u,j+v,c] * k[b,u,v,c]
//
// VALID, x (B, hx, wx, C), k (B, M, hk, wk, C), out (B, M, Ho, Wo, C),
// all contiguous NHWC (C innermost), f32 or bf16 in, f32 accumulation,
// output in the input type. Any B, M, C, kernel size and Wo: no padding.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 without tensor cores)
// at the shapes of the tools that run these kernels (B=32, 29x29 search,
// 5x5 kernel, C=256, Ho=Wo=25): K3 in bf16 moves ~24.4 MB (search 13.8,
// kernels 0.4, output 10.2) = ~7.3 us against 2*25 FMAs per output =
// 256 MFLOP = ~3.8 us, bytes-bound; K2 with M=7 in bf16 moves ~88 MB
// (~26 us) against 1.79 GFLOP (~27 us), at the knee; in f32 both are
// bytes-bound.
//
// Design: K1's, one scale. One thread per output element, c fastest, so
// a warp's loads of x[b, i+u, j+v, c..c+31] and k[b, m, u, v, c..c+31]
// are contiguous and coalesce; the hk*wk taps are a loop with the sum in
// a register. Neighbouring (i, j, m) re-read the same search rows
// through L1/L2. Keeping search rows in shared memory across j and M is
// left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const void* x;  // (B, hx, wx, C)
  const void* k;  // (B, M, hk, wk, C)
  void* out;      // (B, M, Ho, Wo, C)
  int B, M, C, hx, wx, hk, wk, Ho, Wo;
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
__global__ void __launch_bounds__(256) depthwise_kernel(Params p) {
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

  const T* __restrict__ x =
      static_cast<const T*>(p.x) + (int64_t)b * p.hx * p.wx * C + c;
  const T* __restrict__ k = static_cast<const T*>(p.k) +
                            ((int64_t)b * p.M + m) * p.hk * p.wk * C + c;
  float acc = 0.f;
  for (int u = 0; u < p.hk; ++u) {
    const T* xrow = x + ((int64_t)(i + u) * p.wx + j) * C;
    const T* krow = k + (int64_t)u * p.wk * C;
    for (int v = 0; v < p.wk; ++v) {
      acc = fmaf(to_float(xrow[v * C]), to_float(krow[v * C]), acc);
    }
  }
  static_cast<T*>(p.out)[idx] = from_float<T>(acc);
}

int launch(int dtype, Params p, void* stream) {
  const int64_t total = (int64_t)p.B * p.M * p.Ho * p.Wo * p.C;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    depthwise_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(p);
  } else if (dtype == 1) {
    depthwise_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K2. dims: B, M, C, hx, wx, hk, wk. dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int usot_xcorr_depthwise_multi(int dtype, const void* x,
                                          const void* k, void* out,
                                          const int* dims, void* stream) {
  Params p;
  p.x = x;
  p.k = k;
  p.out = out;
  p.B = dims[0];
  p.M = dims[1];
  p.C = dims[2];
  p.hx = dims[3];
  p.wx = dims[4];
  p.hk = dims[5];
  p.wk = dims[6];
  p.Ho = p.hx - p.hk + 1;
  p.Wo = p.wx - p.wk + 1;
  return launch(dtype, p, stream);
}

// K3. dims: B, C, hx, wx, hk, wk; k is (B, hk, wk, C), out
// (B, Ho, Wo, C). Same contract as above.
extern "C" int usot_xcorr_depthwise(int dtype, const void* x, const void* k,
                                    void* out, const int* dims,
                                    void* stream) {
  const int multi[7] = {dims[0], 1, dims[1], dims[2], dims[3], dims[4],
                        dims[5]};
  return usot_xcorr_depthwise_multi(dtype, x, k, out, multi, stream);
}
