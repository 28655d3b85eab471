// int8 weight matmul for Hopper (sm_90a), in two orders of scaling.
//
// Replaces the TPU kernel tilawa_tpu/ops/quant.py:_int8_kernel (launched by
// int8_matmul) and also runs the int8 model family's Dense layers
// (tilawa_tpu/models/fastconformer.py Int8Dense), which scale after the
// product. One kernel body, two orders, chosen at compile time:
//
//   SCALE_IN_W   out[M, N] f32  = bf16(x) @ bf16(float(q[K, N]) * s[n])
//                (_int8_kernel: the weight tile is scaled, then rounded)
//   SCALE_AFTER  out[M, N] bf16 = bf16(bf16(acc) * bf16(s[n])),
//                acc = bf16(x) @ bf16(q)   (Int8Dense: matmul, then scale)
//
// q is int8 with a per-output-column f32 scale. Both orders read q as int8
// from device memory and never write a dequantized [K, N] copy. A bf16
// times an integer of magnitude <= 127 (or a bf16 times a bf16) is exact in
// f32, so only the order of the f32 sums differs from the reference.
//
// What bounds it on the H100: at the streaming model's batch-1 shapes
// (M = 50..400 encoder frames, the pos projection at 2T-1 rows, K, N =
// 512..2048, N = 1025 for the CTC head) each forward reads 108,790,272 B (104 MiB)
// of int8 weights for 2 * 108.8M * M operations, far below the bf16 ridge:
// the function is bound by device-memory bytes, and the weight bytes are
// nearly all of them. The design reads each weight byte once per output
// row tile: a block stages a [BK, BN] tile of q (converted, and scaled for
// SCALE_IN_W, on the way) in shared memory beside the matching x rows and
// accumulates a [BM, BN] f32 tile in registers on the CUDA cores; ragged
// edges (M, and N = 1025) are masked. At batch 1 the [M, N] grid is 16..64
// blocks for 132 SMs, so the K loop is split across blocks as in
// int4_matmul.cu: partial tiles go to a workspace and a second kernel sums
// them in a fixed order and applies the epilogue, so the result does not
// depend on scheduling. Tensor-core (mma/wgmma) tiles, vector loads of q and
// TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 32;       // K rows per shared-memory stage
constexpr int THREADS = 256; // 16 x 16 threads, each 2 rows x 4 columns

constexpr int SCALE_IN_W = 0;
constexpr int SCALE_AFTER = 1;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The final value of output element i (column n) from its f32 sum.
template <int ORDER>
__device__ __forceinline__ void store(void* out, size_t i, int n, float acc,
                                      const float* __restrict__ scales) {
  if (ORDER == SCALE_IN_W) {
    static_cast<float*>(out)[i] = acc;
  } else {
    // bf16 x bf16 is exact in f32; one rounding to bf16, as a bf16 multiply.
    static_cast<__nv_bfloat16*>(out)[i] =
        __float2bfloat16_rn(round_bf16(acc) * round_bf16(scales[n]));
  }
}

// Block (bx, by, bz) computes the [BM, BN] tile at (by, bx) over the K rows
// [bz * k_chunk, min(K, (bz + 1) * k_chunk)). SPLIT: the raw f32 sums go to
// the workspace slice bz; otherwise the epilogue writes `out`.
template <int ORDER, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ q,
                   const float* __restrict__ scales,
                   void* __restrict__ out, int M, int K, int N, int k_chunk) {
  // x stored transposed ([k][m]) so the inner loop reads a row pair with one
  // broadcast; the +1 pad keeps the transposing stores free of bank conflicts.
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < k_end) ? __bfloat162float(x[(size_t)m * K + k]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      float w = 0.f;
      if (k < k_end && n < N) {
        w = (float)q[(size_t)k * N + n];
        if (ORDER == SCALE_IN_W) w = round_bf16(w * scales[n]);
      }
      ws[r][c] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = xs[kk][ty * 2];
      const float a1 = xs[kk][ty * 2 + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = ws[kk][tx + 16 * j];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty * 2 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const size_t idx = (size_t)m * N + n;
      if (SPLIT) {
        static_cast<float*>(out)[(size_t)blockIdx.z * M * N + idx] = acc[i][j];
      } else {
        store<ORDER>(out, idx, n, acc[i][j], scales);
      }
    }
  }
}

// out[i] = epilogue(sum over z of partial[z][i], in order of z).
template <int ORDER>
__global__ void splitk_sum_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scales,
                                  void* __restrict__ out, int size, int N,
                                  int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += partial[(size_t)z * size + i];
  store<ORDER>(out, i, i % N, acc, scales);
}

template <int ORDER>
int launch(const void* x, const void* q, const void* scales, void* out,
           void* workspace, int M, int K, int N, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_tiles = (K + BK - 1) / BK;
  const int k_chunk = ((k_tiles + splits - 1) / splits) * BK;
  splits = (K + k_chunk - 1) / k_chunk;  // no empty split
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sc = static_cast<const float*>(scales);
  if (splits > 1) {
    int8_matmul_kernel<ORDER, true><<<grid, THREADS, 0, s>>>(
        xb, qb, sc, workspace, M, K, N, k_chunk);
    const int size = M * N;
    splitk_sum_kernel<ORDER><<<(size + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(workspace), sc, out, size, N, splits);
  } else {
    int8_matmul_kernel<ORDER, false><<<grid, THREADS, 0, s>>>(
        xb, qb, sc, out, M, K, N, k_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: bf16 [M, K]; q: int8 [K, N]; scales: f32 [N]; workspace: f32
// [splits, M, N] when splits > 1 (unused otherwise); all contiguous on one
// device; 1 <= splits <= ceil(K/32). Each returns cudaGetLastError() after
// its launches on `stream`.

// out: f32 [M, N] = bf16(x) @ bf16(float(q) * scales)   (_int8_kernel)
extern "C" int tilawa_int8_matmul(const void* x, const void* q, const void* scales,
                                  void* out, void* workspace, int M, int K, int N,
                                  int splits, void* stream) {
  return launch<SCALE_IN_W>(x, q, scales, out, workspace, M, K, N, splits, stream);
}

// out: bf16 [M, N] = bf16(bf16(bf16(x) @ bf16(q)) * bf16(scales))   (Int8Dense)
extern "C" int tilawa_int8_dense(const void* x, const void* q, const void* scales,
                                 void* out, void* workspace, int M, int K, int N,
                                 int splits, void* stream) {
  return launch<SCALE_AFTER>(x, q, scales, out, workspace, M, K, N, splits, stream);
}
