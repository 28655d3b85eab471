// int4 dequantizing matmul for Hopper (sm_90a): the split-half int4 loader
// of quant_matmul.cuh with two epilogues.
//
// Replaces the TPU kernel tilawa_tpu/ops/quant.py:_int4_kernel (launched by
// int4_matmul) and runs flax Int4Dense (tilawa_tpu/models/fastconformer.py)
// with its bf16 cast and bias add fused:
//
//   tilawa_int4_matmul  f32  = bf16(x) @ bf16(unpack(q4) * scale) (+ bias)
//   tilawa_int4_dense   bf16 = bf16(bf16(acc) + bf16(bias))
//
// quant_matmul.cuh says what bounds the function and what the design does.

#include "quant_matmul.cuh"

// x: bf16 [M, K]; packed: uint8 [K/2, N]; scales: f32 [ceil(K/32), N]; bias:
// f32 [N] or null; out: [M, N]; workspace: f32, ceil(M/64)*64 x
// ceil(N/64)*64 x splits; all contiguous on one device. K even, and K/2 a
// multiple of 32 or K <= 32; 1 <= splits <= 8; bn (columns per block) 32 or
// 64. Each returns the launch's CUDA error (0 when it was launched) on
// `stream`.

extern "C" int tilawa_int4_matmul(const void* x, const void* packed, const void* scales,
                                  const void* bias, void* out, void* workspace, int M, int K,
                                  int N, int splits, int bn, void* stream) {
  return tilawa::launch<tilawa::INT4_SPLIT_HALF, tilawa::EPI_F32>(
      x, packed, scales, bias, out, workspace, M, K, N, splits, bn, stream);
}

extern "C" int tilawa_int4_dense(const void* x, const void* packed, const void* scales,
                                 const void* bias, void* out, void* workspace, int M, int K,
                                 int N, int splits, int bn, void* stream) {
  return tilawa::launch<tilawa::INT4_SPLIT_HALF, tilawa::EPI_BF16>(
      x, packed, scales, bias, out, workspace, M, K, N, splits, bn, stream);
}
