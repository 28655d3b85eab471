// int8 weight matmul for Hopper (sm_90a), in two orders of scaling: the int8
// loaders of quant_matmul.cuh with their epilogues.
//
// Replaces the TPU kernel tilawa_tpu/ops/quant.py:_int8_kernel (launched by
// int8_matmul) and runs the int8 model family's Dense layers
// (tilawa_tpu/models/fastconformer.py Int8Dense), which scale after the
// product, with the bias add fused:
//
//   tilawa_int8_matmul  f32  = bf16(x) @ bf16(float(q) * s[n]) (+ bias)
//                       (_int8_kernel: the weight tile is scaled, then rounded)
//   tilawa_int8_dense   bf16 = bf16(bf16(bf16(acc) * bf16(s[n])) + bf16(bias)),
//                       acc = bf16(x) @ bf16(q)   (Int8Dense: matmul, then scale)
//
// quant_matmul.cuh says what bounds the function and what the design does.

#include "quant_matmul.cuh"

// x: bf16 [M, K]; q: int8 [K, N]; scales: f32 [N]; bias: f32 [N] or null;
// out: [M, N]; workspace: f32, ceil(M/64)*64 x ceil(N/64)*64 x splits; all
// contiguous on one device; 1 <= splits <= 8; bn (columns per block) 32 or
// 64. Each returns the launch's CUDA error (0 when it was launched) on
// `stream`.

extern "C" int tilawa_int8_matmul(const void* x, const void* q, const void* scales,
                                  const void* bias, void* out, void* workspace, int M, int K,
                                  int N, int splits, int bn, void* stream) {
  return tilawa::launch<tilawa::INT8_SCALED, tilawa::EPI_F32>(
      x, q, scales, bias, out, workspace, M, K, N, splits, bn, stream);
}

extern "C" int tilawa_int8_dense(const void* x, const void* q, const void* scales,
                                 const void* bias, void* out, void* workspace, int M, int K,
                                 int N, int splits, int bn, void* stream) {
  return tilawa::launch<tilawa::INT8_RAW, tilawa::EPI_SCALE_BF16>(
      x, q, scales, bias, out, workspace, M, K, N, splits, bn, stream);
}
