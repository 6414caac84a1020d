// K1: fused 3-scale GroupDW depthwise cross-correlation for Hopper
// (sm_90a).
//
// Replaces the TPU kernel usot_tpu/ops/pallas/xcorr_kernel.py::
// xcorr_groupdw_pallas (body _groupdw_multi_kernel). It computes, VALID,
//
//   out[b,m,i,j,c] = sum_{s<3} sum_{u<hk_s, v<wk_s}
//                    x_s[b, i+u, j+v, c] * k_s[b, m, u, v, c]
//
// with x_s (B, hx_s, wx_s, C), k_s (B, M, hk_s, wk_s, C) and out
// (B, M, Ho, Wo, C), contiguous NHWC, f32 or bf16 in, f32 accumulation,
// output in the input type. The three scales share one (Ho, Wo); the
// caller checks that. Kernels are at most 8 x 8.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s FP32, no tensor cores):
// bytes at every production shape. At the batch engine's B=32, M=7,
// C=256, 55 taps, Ho=Wo=25 in f32 it moves 235 MB (search maps 79,
// kernels 13, output 143) = 70 us, against 2.0 G FMAs = 59 us; at M=1
// 101 MB = 30 us; the tracker's B=1 shapes 1/32 of that, under the cost
// of a launch.
//
// Design: xcorr_tile.cuh at NS = 3. A block stages its band of search
// rows of all three scales and the taps of its kernels in shared memory
// once; every kernel m reads the rows there, and a thread keeps 2 x 9
// outputs in registers, loading each search value once for the output
// rows it feeds (0.26 loads per FMA at 5-wide taps). The one-thread-per-
// output kernel it replaces loaded both operands of every FMA and was
// bound by its loads at 39x the bound.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8), per instantiation, 384 threads
// a block: xcorr_tile_kernel<float, 3> 80 registers, <__nv_bfloat16, 3>
// 79; 0 bytes stack, no spills, no static shared memory, 1 barrier.
// Dynamic shared memory per block, sized by launch_tile
// for two blocks per SM: at B=32, instance 255, f32, 111,232 B with M=7
// (bands of 2 rows, all 7 kernels' taps) and 103,936 B with M=1 (bands
// of 5 rows); half in bf16. At B=1 the grid splits along M and bands.
#include "xcorr_tile.cuh"

// dims: B, M, C, Ho, Wo, then (hx, wx, hk, wk) for each of the 3 scales.
// dtype: 0 = float32, 1 = bfloat16. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int usot_xcorr_groupdw(int dtype, const void* x0, const void* x1,
                                  const void* x2, const void* k0,
                                  const void* k1, const void* k2, void* out,
                                  const int* dims, void* stream) {
  usot_xcorr::Params p = {};
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
  return usot_xcorr::launch<3>(dtype, p, stream);
}
