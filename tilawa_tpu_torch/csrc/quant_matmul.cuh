// One quantized-weight matmul for Hopper (sm_90a), templated over its
// weight loader and its epilogue. int4_matmul.cu and int8_matmul.cu include
// it and export the C launchers of the instances they need.
//
// Replaces the TPU kernels tilawa_tpu/ops/quant.py:_int4_kernel and
// :_int8_kernel, and runs the layers built on them (flax Int4Dense and
// Int8Dense, tilawa_tpu/models/fastconformer.py). Every instance computes
//
//   acc[M, N] (f32) = bf16(x[M, K]) @ W[K, N] (bf16)
//
// and hands acc to its epilogue. The loaders build the bf16 W tile:
//
//   INT4_SPLIT_HALF  bf16(float(q4) * scales[k / 32, n]); packed[k2, n] holds
//                    row k2 in its low nibble and row k2 + K/2 in its high
//                    nibble, sign by (v ^ 8) - 8        (_int4_kernel)
//   INT8_SCALED      bf16(float(q[k, n]) * scales[n])   (_int8_kernel)
//   INT8_RAW         bf16(q[k, n]), exact for |q| <= 127 (Int8Dense)
//
// and the epilogues write, per element (bias optional, f32 in memory):
//
//   EPI_F32          acc (+ bias): the TPU kernels' own f32 output
//   EPI_BF16         bf16(bf16(acc) + bf16(bias))       (Int4Dense)
//   EPI_SCALE_BF16   y = bf16(bf16(acc) * bf16(scales[n])), then
//                    bf16(y + bf16(bias))               (Int8Dense)
//
// Each bf16 step is one f32 operation and one round to nearest even, which
// is what PyTorch's bf16 cast, multiply and add do; so the fused epilogue is
// bit-equal to the layer's cast, scale and bias add given the same acc. The
// products are bf16 x bf16, exact in f32, on the tensor cores (mma.sync
// m16n8k16, f32 accumulation): only the order of the f32 sums differs from
// the plain version.
//
// Row invariance. Each output element's sum order is fixed by K and N only:
// the K range is cut into `splits` (chosen from K, N and the SM count, never
// from M) runs of whole 64-deep stages, each block sums its run stage by
// stage in one order (16-deep mma steps, the same for every row and column),
// and the `splits` blocks of an output tile, launched as one thread-block
// cluster, add their partial tiles in the order z = 0 .. splits-1 inside the
// same launch. The tile width (BN = 32, 64 or 128 columns) follows M, but no
// element's arithmetic depends on it. So row r of f(x) is bitwise the same
// however many rows share the launch.
//
// What bounds it on the H100: at the paths' shapes (M = 50..799 rows, K, N =
// 512..2560) the weights are most of the bytes and a product is far below
// the bf16 ridge: the function is bound by device-memory bytes, and at batch
// 1 a launch is mostly latency. The design: 64-row tiles, 32 columns wide up
// to two row tiles, where split-K gives about one block per SM, and 64 or
// 128 wide beyond, so that x is read from L2 fewer times; eight warps per
// block, each 16 rows by half the columns; 16-byte cp.async loads of x, of
// the quantized weights (each packed int4 byte read once: a stage takes a
// low-half K tile and its high-half twin together) and of the int4 scales,
// three stages deep; the weights are dequantized from shared memory into a
// bf16 tile in shared memory, once per block and stage, and fed to the
// tensor cores with ldmatrix. Each block writes its f32 partial tile (rows
// below M only) to an L2-resident workspace, one hardware cluster barrier
// orders the writes, and each block of the cluster sums its share of the
// tile over the partials and writes it with coalesced vector stores; the
// epilogue's scales and bias are staged in shared memory while the first
// stage loads. What remains is latency: a cold load, one stage's products,
// the barrier and the partials' round trip through L2.
// Weight rows that are not 16-byte aligned (N = 1025 for the text CTC head,
// 70 for the phoneme head) are loaded with plain loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tilawa {

constexpr int BM = 64;             // output rows per block
constexpr int BK = 64;             // K rows per stage (int4: 32 packed rows, both halves)
constexpr int THREADS = 256;       // 8 warps: 4 along M (16 rows each) x 2 along N
constexpr int X_LD = BK + 8;       // padded shared rows: ldmatrix without bank conflicts
constexpr int QBLOCK = 32;         // K rows per int4 scale group
constexpr int MAX_SPLITS = 8;      // blocks per cluster (the portable limit)

enum Loader { INT4_SPLIT_HALF, INT8_SCALED, INT8_RAW };
enum Epilogue { EPI_F32, EPI_BF16, EPI_SCALE_BF16 };

struct Params {
  const __nv_bfloat16* x;  // [M, K]
  const uint8_t* w;        // int4: packed [K/2, N]; int8: q [K, N]
  const float* scales;     // int4: [ceil(K/32), N]; int8: [N]
  const float* bias;       // [N] or null
  void* out;               // [M, N], f32 or bf16 by epilogue
  float* workspace;        // [tiles, splits, BM * BN]: the partial tiles
  int M, K, N, splits;
};

// Shared memory of a BM x BN tile with a STAGES-deep load ring.
template <int BN, int STAGES>
struct Smem {
  __nv_bfloat16 x[STAGES][BM][X_LD];
  uint8_t raw[STAGES][BK][BN];
  float sc[STAGES][2][BN];       // int4: scale rows of the low and high halves
  __nv_bfloat16 w[BK][BN + 8];
  float ep_scale[BN], ep_bias[BN];
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A cluster barrier whose release / acquire orders the cluster's memory
// writes before it against its reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// K column of x that column c (0..BK-1) of stage `gs`'s x tile holds. int4:
// the first half of the tile pairs with the packed rows' low nibbles, the
// second half with their high nibbles (K/2 further on).
template <int LOADER>
__device__ __forceinline__ int x_col(int gs, int c, int K) {
  if (LOADER == INT4_SPLIT_HALF) {
    const int p = gs * (BK / 2) + (c % (BK / 2));
    if (p >= K / 2) return K;  // past the packed rows: a column past the end
    return c < BK / 2 ? p : K / 2 + p;
  }
  return gs * BK + c;
}

// Issues (16-byte cp.async: VX for x, VW for the weights and scales) or
// performs (plain loads) the loads of stage `gs` into ring slot `slot`: the
// x tile, the raw weight tile and, for int4, the two scale rows. The chunk
// counts are compile-time constants, so each thread's share unrolls into
// straight-line address arithmetic.
template <int LOADER, bool VX, bool VW, int BN, int STAGES>
__device__ __forceinline__ void load_stage(Smem<BN, STAGES>& sm, const Params& p, int tid,
                                           int slot, int gs, int m0, int n0) {
  constexpr bool int4 = LOADER == INT4_SPLIT_HALF;
  constexpr int W_ROWS = int4 ? BK / 2 : BK;    // raw rows per stage
  const int K = p.K, N = p.N;
  const int w_limit = int4 ? K / 2 : K;          // raw rows in all
  const int w_row0 = gs * W_ROWS;
  if (VX) {
    // BM rows x BK/8 chunks of 8 bf16
    constexpr int CHUNKS = BM * (BK / 8);
#pragma unroll
    for (int u = 0; u < CHUNKS / THREADS; ++u) {
      const int i = tid + u * THREADS;
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int m = m0 + r, k = x_col<LOADER>(gs, c, K);
      const bool ok = m < p.M && k < K;
      cp_async16(&sm.x[slot][r][c], ok ? p.x + (size_t)m * K + k : p.x, ok);
    }
  } else {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = x_col<LOADER>(gs, c, K);
      sm.x[slot][r][c] =
          (m < p.M && k < K) ? p.x[(size_t)m * K + k] : __float2bfloat16_rn(0.f);
    }
  }
  if (VW) {
    // W_ROWS x BN/16 chunks of 16 bytes; int4 scales: 2 halves x BN/4
    // chunks of 4 floats
    constexpr int CHUNKS = W_ROWS * (BN / 16);
#pragma unroll
    for (int u = 0; u < (CHUNKS + THREADS - 1) / THREADS; ++u) {
      const int i = tid + u * THREADS;
      if (CHUNKS % THREADS == 0 || i < CHUNKS) {
        const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
        const int row = w_row0 + r, n = n0 + c;
        const bool ok = row < w_limit && n < N;
        cp_async16(&sm.raw[slot][r][c], ok ? p.w + (size_t)row * N + n : p.w, ok);
      }
    }
    if (int4 && tid < 2 * (BN / 4)) {
      const int half = tid / (BN / 4), c = (tid % (BN / 4)) * 4;
      const int group = (half ? K / 2 + w_row0 : w_row0) / QBLOCK;
      const int n = n0 + c;
      const bool ok = n < N;
      cp_async16(&sm.sc[slot][half][c], ok ? p.scales + (size_t)group * N + n : p.scales, ok);
    }
  } else {
    for (int i = tid; i < W_ROWS * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int row = w_row0 + r, n = n0 + c;
      sm.raw[slot][r][c] = (row < w_limit && n < N) ? p.w[(size_t)row * N + n] : 0;
    }
    if (int4) {
      for (int i = tid; i < 2 * BN; i += THREADS) {
        const int half = i / BN, c = i % BN;
        const int group = (half ? K / 2 + w_row0 : w_row0) / QBLOCK;
        const int n = n0 + c;
        sm.sc[slot][half][c] = n < N ? p.scales[(size_t)group * N + n] : 0.f;
      }
    }
  }
}

// Four values rounded to bf16 (nearest even, as __float2bfloat16_rn) into
// dst[0..3], one 8-byte store.
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float a, float b, float c,
                                             float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 bits;
  bits.x = *reinterpret_cast<const unsigned*>(&lo);
  bits.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = bits;
}

// Integer to float without the conversion unit (a quarter-rate pipe that
// bounds the dequantization): u in [0, 256) OR-ed into the mantissa of 2^23
// is the float 2^23 + u, exactly; subtracting 2^23 + bias gives u - bias.

// The signed nibble of byte j of `word`, low (HIGH false) or high half:
// (v ^ 8) - 8, as float.
template <bool HIGH>
__device__ __forceinline__ float nibble(uint32_t word, int j) {
  const uint32_t v = (word >> (8 * j + (HIGH ? 4 : 0))) & 0xFu;
  return __uint_as_float(v ^ 0x4B000008u) - 8388616.0f;  // 2^23 + 8
}

// Byte j of `word` as a signed int8, as float; `flipped` is word ^ 0x80808080
// (each byte q + 128).
__device__ __forceinline__ float int8_byte(uint32_t flipped, int j) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540 + j)) - 8388736.0f;
}

// Raw tile of ring slot `slot` -> the bf16 W tile. Thread t owns columns
// 4 (t % (BN/4)) .. +3 and every (THREADS / (BN/4))-th row from t / (BN/4);
// `col_scale` holds INT8_SCALED's four column scales.
template <int LOADER, int BN, int STAGES>
__device__ __forceinline__ void dequantize(Smem<BN, STAGES>& sm, int tid, int slot,
                                           const float (&col_scale)[4]) {
  constexpr int ROW_STEP = THREADS / (BN / 4);
  const int c = 4 * (tid % (BN / 4));
  const int r0 = tid / (BN / 4);
  if (LOADER == INT4_SPLIT_HALF) {
    const float4 lo = *reinterpret_cast<const float4*>(&sm.sc[slot][0][c]);
    const float4 hi = *reinterpret_cast<const float4*>(&sm.sc[slot][1][c]);
#pragma unroll
    for (int u = 0; u < BK / 2 / ROW_STEP; ++u) {
      const int r = r0 + u * ROW_STEP;
      const uint32_t word = *reinterpret_cast<const uint32_t*>(&sm.raw[slot][r][c]);
      store_bf16x4(&sm.w[r][c], nibble<false>(word, 0) * lo.x, nibble<false>(word, 1) * lo.y,
                   nibble<false>(word, 2) * lo.z, nibble<false>(word, 3) * lo.w);
      store_bf16x4(&sm.w[BK / 2 + r][c], nibble<true>(word, 0) * hi.x,
                   nibble<true>(word, 1) * hi.y, nibble<true>(word, 2) * hi.z,
                   nibble<true>(word, 3) * hi.w);
    }
  } else {
#pragma unroll
    for (int u = 0; u < BK / ROW_STEP; ++u) {
      const int r = r0 + u * ROW_STEP;
      const uint32_t flipped =
          *reinterpret_cast<const uint32_t*>(&sm.raw[slot][r][c]) ^ 0x80808080u;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = int8_byte(flipped, j);
        if (LOADER == INT8_SCALED) v[j] *= col_scale[j];
      }
      store_bf16x4(&sm.w[r][c], v[0], v[1], v[2], v[3]);
    }
  }
}

// One stage's products: warp w owns tile rows 16 (w % 4) .. +15 and the
// columns (w / 4) BN/2 .. +BN/2-1 (BN/16 n8 tiles), acc[j] the m16n8
// fragment of its n8 tile j.
template <int BN, int STAGES>
__device__ __forceinline__ void mma_stage(const Smem<BN, STAGES>& sm, int tid, int slot,
                                          float (&acc)[BN / 16][4]) {
  const int lane = tid % 32, warp = tid / 32;
  const int row = 16 * (warp % 4), col = (warp / 4) * (BN / 2);
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    unsigned a[4];
    ldmatrix_x4(a, &sm.x[slot][row + lane % 16][kk + (lane / 16) * 8]);
#pragma unroll
    for (int jj = 0; jj < BN / 32; ++jj) {
      unsigned b[4];
      ldmatrix_x4_trans(b, &sm.w[kk + lane % 16][col + 16 * jj + (lane / 16) * 8]);
      mma_bf16(acc[2 * jj], a, b[0], b[1]);
      mma_bf16(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// The epilogue of output element (m, n0 + c) from its f32 sum.
template <int EPI, int BN, int STAGES>
__device__ __forceinline__ float epilogue(const Smem<BN, STAGES>& sm, const Params& p, int c,
                                          float acc) {
  if (EPI == EPI_F32) return p.bias ? acc + sm.ep_bias[c] : acc;
  float y = round_bf16(acc);
  if (EPI == EPI_SCALE_BF16) y = round_bf16(y * round_bf16(sm.ep_scale[c]));
  if (p.bias) y = y + round_bf16(sm.ep_bias[c]);
  return y;
}

// Output elements (m, n0 + c .. n0 + c + 3): one vector store where the row
// allows it.
template <int EPI, int BN, int STAGES>
__device__ __forceinline__ void store4(const Smem<BN, STAGES>& sm, const Params& p, int m,
                                       int n0, int c, float4 acc) {
  const int n = n0 + c;
  if (m >= p.M || n >= p.N) return;
  const float v[4] = {epilogue<EPI>(sm, p, c, acc.x), epilogue<EPI>(sm, p, c + 1, acc.y),
                      epilogue<EPI>(sm, p, c + 2, acc.z), epilogue<EPI>(sm, p, c + 3, acc.w)};
  const size_t i = (size_t)m * p.N + n;
  if (p.N % 4 == 0 && n + 3 < p.N) {
    if (EPI == EPI_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + i) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
      store_bf16x4(static_cast<__nv_bfloat16*>(p.out) + i, v[0], v[1], v[2], v[3]);
    }
    return;
  }
  for (int e = 0; e < 4 && n + e < p.N; ++e) {
    if (EPI == EPI_F32) {
      static_cast<float*>(p.out)[i + e] = v[e];
    } else {
      static_cast<__nv_bfloat16*>(p.out)[i + e] = __float2bfloat16_rn(v[e]);
    }
  }
}

// Grid (ceil(N/BN), ceil(M/BM), splits) in clusters of (1, 1, splits); block
// (x, y, z) sums the K stages [z * per, (z + 1) * per) of run z for the
// output tile (y, x).
template <int LOADER, int EPI, bool VX, bool VW, int BN, int STAGES>
__global__ void __launch_bounds__(THREADS) quant_matmul_kernel(const Params p) {
  using S = Smem<BN, STAGES>;
  constexpr int NT = BN / 16;     // n8 tiles per warp
  constexpr int Q = BM * BN / 4;  // float4s in the tile
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);
  const int tid = threadIdx.x;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_stages = (p.K + BK - 1) / BK;
  const int per = (k_stages + p.splits - 1) / p.splits;
  const int s_begin = blockIdx.z * per;
  const int n_st = max(0, min(k_stages, s_begin + per) - s_begin);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_st) load_stage<LOADER, VX, VW>(sm, p, tid, s, s_begin + s, m0, n0);
    cp_async_commit();
  }
  // the epilogue's per-column values, fetched while the stages load
  for (int c = tid; c < BN; c += THREADS) {
    const int n = n0 + c;
    if (EPI == EPI_SCALE_BF16) sm.ep_scale[c] = n < p.N ? p.scales[n] : 0.f;
    if (p.bias) sm.ep_bias[c] = n < p.N ? p.bias[n] : 0.f;
  }
  float col_scale[4] = {0.f, 0.f, 0.f, 0.f};
  if (LOADER == INT8_SCALED) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * (tid % (BN / 4)) + j;
      col_scale[j] = n < p.N ? p.scales[n] : 0.f;
    }
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; stage s-1's slot and the W tile are free
    const int next = s + STAGES - 1;
    if (next < n_st) load_stage<LOADER, VX, VW>(sm, p, tid, next % STAGES, s_begin + next, m0, n0);
    cp_async_commit();
    dequantize<LOADER>(sm, tid, s % STAGES, col_scale);
    __syncthreads();
    mma_stage(sm, tid, s % STAGES, acc);
  }
  cp_async_wait<0>();

  // Split-K sum. Every block writes its partial tile, row-major, to the
  // workspace (m16n8 fragment j of a warp holds rows g and g + 8, columns
  // 8j + 2t and + 1 of the warp's block); after one cluster barrier the
  // block of rank r sums the r-th share of the tile's float4s over the runs
  // z = 0 .. splits-1 in order and writes it.
  const int splits = p.splits;
  float* const partials =
      p.workspace + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * splits * (BM * BN);
  {
    const int lane = tid % 32, warp = tid / 32;
    const int row = 16 * (warp % 4) + lane / 4, col = (warp / 4) * (BN / 2) + 2 * (lane % 4);
    float* mine = partials + (size_t)blockIdx.z * (BM * BN) + row * BN + col;
#pragma unroll
    for (int j = 0; j < NT; ++j) {  // rows past M are neither written nor read
      if (m0 + row < p.M)
        *reinterpret_cast<float2*>(mine + 8 * j) = make_float2(acc[j][0], acc[j][1]);
      if (m0 + row + 8 < p.M)
        *reinterpret_cast<float2*>(mine + 8 * BN + 8 * j) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  if (splits > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
  const int rank = blockIdx.z;  // = the block's rank in its (1, 1, splits) cluster
  const int q_end = min((rank + 1) * Q / splits, (p.M - m0) * (BN / 4));
  for (int q = rank * Q / splits + tid; q < q_end; q += THREADS) {
    float4 part[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) part[r] = __ldcg(reinterpret_cast<const float4*>(partials) + r * Q + q);
    float4 sum = part[0];
#pragma unroll
    for (int r = 1; r < MAX_SPLITS; ++r)
      if (r < splits) {
        sum.x += part[r].x, sum.y += part[r].y, sum.z += part[r].z, sum.w += part[r].w;
      }
    const int row = q / (BN / 4), c = 4 * (q % (BN / 4));
    store4<EPI>(sm, p, m0 + row, n0, c, sum);
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <int LOADER, int EPI, bool VX, bool VW, int BN>
cudaError_t launch_tile(const Params& p, cudaStream_t stream) {
  constexpr int STAGES = 3;
  auto kernel = quant_matmul_kernel<LOADER, EPI, VX, VW, BN, STAGES>;
  constexpr int bytes = (int)sizeof(Smem<BN, STAGES>);
  static const cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (configured != cudaSuccess) return configured;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.splits);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = p.splits;
  config.attrs = cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, p);
}

// Launches one product on `stream` as clusters of `splits` blocks
// (1 <= splits <= MAX_SPLITS), `bn` (32, 64 or 128) columns per block, with
// a workspace of at least ceil(M/64)*64 x ceil(N/128)*128 x splits floats.
// Returns the launch's error, else cudaGetLastError().
template <int LOADER, int EPI>
int launch(const void* x, const void* w, const void* scales, const void* bias, void* out,
           void* workspace, int M, int K, int N, int splits, int bn, void* stream) {
  const Params p{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
                 static_cast<const float*>(scales), static_cast<const float*>(bias), out,
                 static_cast<float*>(workspace), M, K, N, splits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > MAX_SPLITS) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads need 16-byte rows: x rows (int4: also the high half's
  // offset K/2), weight and scale rows
  const bool vx = (LOADER == INT4_SPLIT_HALF ? K % 16 == 0 : K % 8 == 0) && aligned16(x);
  const bool vw = N % 16 == 0 && aligned16(w) && aligned16(scales);
  cudaError_t err;
  if (!vw) {  // the narrow tile only: a misaligned N is a CTC head's (N = 1025 or 70)
    err = vx ? launch_tile<LOADER, EPI, true, false, 32>(p, s)
             : launch_tile<LOADER, EPI, false, false, 32>(p, s);
  } else if (!vx) {
    err = launch_tile<LOADER, EPI, false, true, 32>(p, s);
  } else if (bn == 128) {
    err = launch_tile<LOADER, EPI, true, true, 128>(p, s);
  } else if (bn == 64) {
    err = launch_tile<LOADER, EPI, true, true, 64>(p, s);
  } else {
    err = launch_tile<LOADER, EPI, true, true, 32>(p, s);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace tilawa
