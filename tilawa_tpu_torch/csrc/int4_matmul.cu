// int4 dequantizing matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel tilawa_tpu/ops/quant.py:_int4_kernel (launched by
// int4_matmul). It computes
//
//   out[M, N] (f32) = bf16(x[M, K]) @ bf16(float(q[K, N]) * scales[k / 32, n])
//
// where q is unpacked from split-half nibbles: packed[k2, n] holds row k2 in
// its low nibble and row k2 + K/2 in its high nibble, sign by (v ^ 8) - 8.
// The rounding points are the JAX kernel's: x is rounded to bf16, each weight
// is dequantized in f32 and then rounded to bf16, and products and sums are
// f32. A product of two bf16 values is exact in f32, so only the order of
// the f32 sums differs from the reference.
//
// What bounds it on the H100: at the main path's batch-1 shapes (M = 50..400
// encoder frames, K, N = 512..2560) the packed weight bytes dominate and the
// arithmetic intensity is far below the bf16 ridge, so the function is
// bound by device-memory bytes. The design keeps the dequantized W out of
// device memory: each block unpacks a [BK, BN] tile of nibbles straight
// into shared memory, stages the matching x rows beside it, and accumulates
// a [BM, BN] output tile in f32 registers on the CUDA cores; the ragged
// edges (M, and N = 1025 for the CTC head) are masked. At batch 1 the
// [M, N] grid is only 16..64 blocks for 132 SMs, so the K loop is split
// across `splits` blocks (split-K): each writes its partial tile to a
// workspace and a second kernel sums the partials in a fixed order, so the
// result does not depend on scheduling. Tensor-core (mma/wgmma) tiles and
// TMA loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 32;       // K rows per shared-memory stage
constexpr int THREADS = 256; // 16 x 16 threads, each 2 rows x 4 columns
constexpr int QBLOCK = 32;   // K rows per scale group (INT4_BLOCK)

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Block (bx, by, bz) computes the [BM, BN] tile at (by, bx) over the K rows
// [bz * k_chunk, min(K, (bz + 1) * k_chunk)) and writes it to
// out + bz * M * N (the workspace slice bz when split, `out` itself when not).
__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ packed,
                   const float* __restrict__ scales,
                   float* __restrict__ out, int M, int K, int N, int k_chunk) {
  // x stored transposed ([k][m]) so the inner loop reads a row pair with one
  // broadcast; the +1 pad keeps the transposing stores free of bank conflicts.
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int half = K / 2;

  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  out += (size_t)blockIdx.z * M * N;
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
        const bool high = k >= half;
        const uint8_t p = packed[(size_t)(high ? k - half : k) * N + n];
        const int q = (((high ? p >> 4 : p) & 0xF) ^ 8) - 8;
        w = round_bf16((float)q * scales[(size_t)(k / QBLOCK) * N + n]);
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
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// out[i] = sum over z of partial[z][i], in order of z.
__global__ void splitk_sum_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int size, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += partial[(size_t)z * size + i];
  out[i] = acc;
}

}  // namespace

// x: bf16 [M, K]; packed: uint8 [K/2, N]; scales: f32 [ceil(K/32), N];
// out: f32 [M, N]; workspace: f32 [splits, M, N] when splits > 1 (unused
// otherwise); all contiguous on one device. K even, 1 <= splits <= K/32.
// Returns cudaGetLastError() after the launches on `stream`.
extern "C" int tilawa_int4_matmul(const void* x, const void* packed,
                                  const void* scales, void* out, void* workspace,
                                  int M, int K, int N, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_tiles = (K + BK - 1) / BK;
  const int k_chunk = ((k_tiles + splits - 1) / splits) * BK;
  splits = (K + k_chunk - 1) / k_chunk;  // no empty split
  float* dst = splits > 1 ? static_cast<float*>(workspace) : static_cast<float*>(out);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int4_matmul_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), dst, M, K, N, k_chunk);
  if (splits > 1) {
    const int size = M * N;
    splitk_sum_kernel<<<(size + 255) / 256, 256, 0, s>>>(
        dst, static_cast<float*>(out), size, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
