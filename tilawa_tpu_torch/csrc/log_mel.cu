// Fused log-mel frontend for Hopper (sm_90a).
//
// Replaces the TPU kernel tilawa_tpu/ops/frontend.py:_mel_kernel (launched by
// fused_log_mel). From the pre-emphasized waveform pre[B, N] it computes, for
// every frame t < T = 1 + (N - 400) / 160 (center=False framing):
//
//   re[k], im[k] = sum_n pre[t*160 + n] * dft_{real,imag}[n, k]   (n < 400, k < 257)
//   out[b, t, m] = ln(sum_k (re[k]^2 + im[k]^2) * fb[k, m] + eps)  (m < 80)
//
// where the DFT tables have the periodic Hann window folded in and, like the
// mel filterbank, are built on the host in float64 and uploaded once as f32.
// Every product is f32 FMA on the CUDA cores: no TF32 and no bf16, because
// the power spectrum spans a huge dynamic range that ln() amplifies at small
// magnitudes (bf16 products drift the normalized features by ~0.5,
// tilawa_tpu/ops/frontend.py:155-157).
//
// What bounds it on the H100: the function needs 640 bytes of input and 320
// of output per frame and, with a 512-point real FFT and the filterbank's
// ~500 non-zero weights, ~14k f32 operations, so the function itself is
// bound by device-memory bytes. This kernel's direct DFT costs
// ~4 * 400 * 257 f32 flops per frame, ~30x that FFT count, so the kernel is
// bound by its own f32 operations, far above the function's bound; an FFT
// (radix stages in shared memory) is what would close the gap, later work.
// The design keeps the 257-bin power
// spectrum out of device memory: a block takes TF consecutive frames of one
// batch row, stages their overlapping samples once in shared memory, and
// each thread owns one frequency bin, reading its column of the tables
// (coalesced, L2-resident) once per block and reusing it for TF frames; the
// power rows stay in shared memory for the mel projection and the log.

#include <cuda_runtime.h>

namespace {

constexpr int WIN = 400;
constexpr int HOP = 160;
constexpr int NFREQ = 257;
constexpr int NMELS = 80;
constexpr int TF = 16;                      // frames per block
constexpr int SPAN = (TF - 1) * HOP + WIN;  // samples those frames cover
constexpr int THREADS = 288;                // 9 warps: one thread per bin

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ pre, const float* __restrict__ dft_real,
               const float* __restrict__ dft_imag, const float* __restrict__ fb,
               float* __restrict__ out, int N, int T, float eps) {
  __shared__ float samples[SPAN];
  __shared__ float power[TF][NFREQ];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const float* src = pre + (size_t)b * N + (size_t)t0 * HOP;
  const int avail = N - t0 * HOP;
  for (int i = threadIdx.x; i < SPAN; i += THREADS) {
    samples[i] = i < avail ? src[i] : 0.f;
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k < NFREQ) {
    float re[TF], im[TF];
#pragma unroll
    for (int f = 0; f < TF; ++f) re[f] = im[f] = 0.f;
    for (int n = 0; n < WIN; ++n) {
      const float c = dft_real[n * NFREQ + k];
      const float s = dft_imag[n * NFREQ + k];
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        const float v = samples[f * HOP + n];
        re[f] = fmaf(v, c, re[f]);
        im[f] = fmaf(v, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < TF; ++f) power[f][k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TF * NMELS; i += THREADS) {
    const int f = i / NMELS, m = i % NMELS;
    const int t = t0 + f;
    if (t >= T) continue;
    float acc = 0.f;
    for (int kk = 0; kk < NFREQ; ++kk) acc = fmaf(power[f][kk], fb[kk * NMELS + m], acc);
    out[((size_t)b * T + t) * NMELS + m] = logf(acc + eps);
  }
}

}  // namespace

// pre: f32 [B, N]; dft_real, dft_imag: f32 [400, 257]; fb: f32 [257, 80];
// out: f32 [B, T, 80] with T >= 1 frames; all contiguous on one device.
// Returns cudaGetLastError() after the launch on `stream`.
extern "C" int tilawa_log_mel(const void* pre, const void* dft_real,
                              const void* dft_imag, const void* fb, void* out,
                              int B, int N, int T, float eps, void* stream) {
  const dim3 grid((T + TF - 1) / TF, B);
  log_mel_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), static_cast<const float*>(dft_real),
      static_cast<const float*>(dft_imag), static_cast<const float*>(fb),
      static_cast<float*>(out), N, T, eps);
  return static_cast<int>(cudaGetLastError());
}
