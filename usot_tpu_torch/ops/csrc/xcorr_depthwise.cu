// K2 and K3: single-scale depthwise cross-correlation for Hopper
// (sm_90a).
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
// contiguous NHWC, f32 or bf16 in, f32 accumulation, output in the input
// type. Kernels are at most 8 x 8.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s FP32, no tensor cores) at
// the tools' shapes (B=32, 29x29 search, 5x5 kernel, C=256, Ho=Wo=25):
// K3 in bf16 moves 24.4 MB (search 13.8, kernels 0.4, output 10.2) =
// 7.3 us against 256 MFLOP = 3.8 us, bytes-bound; K2 with M=7 in bf16
// moves 88 MB (26 us) against 1.79 GFLOP (27 us), at the knee; in f32
// both are bytes-bound.
//
// Design: xcorr_tile.cuh at NS = 1, K1's routine on one scale. A block
// stages its band of search rows and its kernels' taps in shared memory
// once for all M kernels; a thread keeps 2 x 9 outputs in registers. The
// one-thread-per-output kernel it replaces loaded both operands of every
// FMA and took the same time in f32 and bf16, 24-46x its bound.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8), per instantiation, 384 threads
// a block: xcorr_tile_kernel<float, 1> and <__nv_bfloat16, 1> 72
// registers each; 0 bytes stack, no spills, no static shared memory, 1
// barrier. Dynamic shared memory per block, sized by
// launch_tile: at 29x29 / 5x5 and B=32, bands of 7 rows, 66,048 B for K2
// (M=7) and 46,848 B for K3 in f32; half in bf16.
#include "xcorr_tile.cuh"

namespace {

int launch_single(int dtype, const void* x, const void* k, void* out,
                  int B, int M, int C, int hx, int wx, int hk, int wk,
                  void* stream) {
  usot_xcorr::Params p = {};
  p.s[0].x = x;
  p.s[0].k = k;
  p.s[0].hx = hx;
  p.s[0].wx = wx;
  p.s[0].hk = hk;
  p.s[0].wk = wk;
  p.out = out;
  p.B = B;
  p.M = M;
  p.C = C;
  p.Ho = hx - hk + 1;
  p.Wo = wx - wk + 1;
  return usot_xcorr::launch<1>(dtype, p, stream);
}

}  // namespace

// K2. dims: B, M, C, hx, wx, hk, wk. dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int usot_xcorr_depthwise_multi(int dtype, const void* x,
                                          const void* k, void* out,
                                          const int* dims, void* stream) {
  return launch_single(dtype, x, k, out, dims[0], dims[1], dims[2], dims[3],
                       dims[4], dims[5], dims[6], stream);
}

// K3. dims: B, C, hx, wx, hk, wk; k is (B, hk, wk, C), out
// (B, Ho, Wo, C). Same contract as above.
extern "C" int usot_xcorr_depthwise(int dtype, const void* x, const void* k,
                                    void* out, const int* dims,
                                    void* stream) {
  return launch_single(dtype, x, k, out, dims[0], 1, dims[1], dims[2],
                       dims[3], dims[4], dims[5], stream);
}
