// Fused log-mel frontend for Hopper (sm_90a): a shared-memory FFT per frame.
//
// Replaces the TPU kernel tilawa_tpu/ops/frontend.py:_mel_kernel (launched by
// fused_log_mel). From the pre-emphasized waveform pre[B, N] it computes, for
// every frame t < T = 1 + (N - 400) / 160 (center=False framing):
//
//   x[n]         = pre[b, t*160 + n] * window[n]   (n < 400; zero to n < 512)
//   X[k]         = sum_n x[n] exp(-2 pi i n k / 512)           (k < 257)
//   out[b, t, m] = ln(sum_{k in band m} |X[k]|^2 * w[m, k] + eps)   (m < 80)
//
// The 512-point real FFT is one 256-point complex FFT of z[n] = x[2n] +
// i x[2n+1] (radix-4 Stockham, four stages) and a split step to the 257
// real bins. The twiddles exp(-2 pi i m / 512), the periodic Hann window
// and the mel bands are built on the host in float64, rounded to f32 once
// and uploaded. Every product is f32 FMA on the CUDA cores: no TF32 and no
// bf16, because the power spectrum spans a huge dynamic range that ln()
// amplifies at small magnitudes (bf16 products drift the normalized
// features by ~0.5, tilawa_tpu/ops/frontend.py:155-157).
//
// What bounds it on the H100: per frame it must read 640 bytes and write
// 320; the FFT, the power and the filterbank's ~500 non-zero weights are
// ~14k f32 operations, ~0.2 ns of the card's f32 rate, so the function is
// bound by device-memory bytes. At the paths' sizes (400 to 13k frames,
// 0.26 to 8 MB) that bound is under 4 us, so the launch latency and one
// frame's dependent chain are what a call costs, and the main path finds
// the audio and the tables cold in L2. The design keeps that chain short
// and fills the card: one warp per frame (WARPS frames to a block, so the
// block count grows with B*T and a 398-frame batch already spreads over 100
// SMs); every global load is issued at the start, before one barrier (the
// frame's samples with coalesced 4-byte loads into registers, any
// alignment and any N; the twiddles, window and mel bands into shared
// memory), so a call waits on one cold round trip; every FFT stage runs in
// the warp's registers and one 2 KB shared buffer with __syncwarp()
// between stages, its accesses free of bank conflicts (a swizzled buffer
// and the stages' twiddles laid out in the order the lanes read them),
// since at large B*T shared-memory traffic sets the pace; the power
// spectrum stays in shared memory; and the mel step sums each filter over
// its contiguous band of non-zero bins (1-17 bins, 503 weights in all)
// from a host-built table.
//
// A frame's 80 outputs are a fixed function of its 400 samples: every warp
// runs the same instructions in the same order whatever B, N or the
// frame's place in its block, which the streaming cache relies on to equal
// forward_long bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int WIN = 400;
constexpr int HOP = 160;
constexpr int NFFT = 512;
constexpr int NZ = NFFT / 2;         // complex points of the packed frame
constexpr int NFREQ = NFFT / 2 + 1;  // real bins
constexpr int NMELS = 80;
constexpr int WARPS = 4;             // frames per block, one warp each
constexpr int LANES = 32;
constexpr int THREADS = WARPS * LANES;
constexpr int QUARTER = NZ / 4;      // radix-4 butterflies per stage
constexpr int SAMPLES = (WIN + LANES - 1) / LANES;  // a lane's samples of its frame
constexpr int MAX_WEIGHTS = 2 * NFREQ;  // each bin feeds at most two mels
constexpr int NSTW = 3 * (4 + 16 + 64);  // twiddles of the stages p = 4, 16, 64

// z's float2 slot i lives at swz(i): with this swizzle every access of an
// FFT stage (the reads at i + 64r, the writes at 4(i - k) + k + rp) is
// spread over the 32 banks without conflicts
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 2) & 15); }

// stw[p - 4 + (r - 1) p + k] = exp(-2 pi i r k / 4p) = twiddle[r k 128 / p]
// for the stages p = 4, 16, 64, r = 1..3 and k < p, so that the lanes of a
// stage read consecutive entries; the stage p = 1 multiplies by 1
__device__ __forceinline__ int stage_twiddle(int e) {
  const int p = e < 12 ? 4 : e < 60 ? 16 : 64;
  const int rem = e - (p - 4);
  return (rem / p + 1) * (rem % p) * (NFFT / 4 / p);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x));
}

// dst[i] = src[i] for i < n <= COUNT, by the block, unrolled so that every
// load is in flight before the first store waits on one
template <int COUNT, typename V>
__device__ __forceinline__ void stage(V* dst, const V* __restrict__ src, int n = COUNT) {
#pragma unroll
  for (int j = 0; j < (COUNT + THREADS - 1) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (i < n) dst[i] = __ldg(src + i);
  }
}

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ pre, const float* __restrict__ window,
               const float2* __restrict__ twiddle, const int* __restrict__ bands,
               const float* __restrict__ band_weights, float* __restrict__ out,
               int N, int T, int frames, int n_weights, float eps) {
  __shared__ float2 zbuf[WARPS][NZ];
  __shared__ float pbuf[WARPS][NFREQ];
  __shared__ float2 tw[NFREQ];     // exp(-2 pi i k / 512), for the split step
  __shared__ float2 stw[NSTW];
  __shared__ float win[WIN];
  __shared__ int band[NMELS * 3];
  __shared__ float weight[MAX_WEIGHTS];

  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int f = blockIdx.x * WARPS + warp;  // frame b*T + t of out
  const bool active = f < frames;

  // Every global load is issued here, before one barrier: the warp's 400
  // samples into registers and the tables into shared memory.
  float raw[SAMPLES];
  if (active) {
    const int b = f / T, t = f - b * T;
    const float* src = pre + (size_t)b * N + (size_t)t * HOP;
#pragma unroll
    for (int j = 0; j < SAMPLES; ++j) {
      const int n = lane + j * LANES;
      raw[j] = n < WIN ? __ldg(src + n) : 0.f;
    }
  }
  stage<2 * NFREQ>(reinterpret_cast<float*>(tw), reinterpret_cast<const float*>(twiddle));
#pragma unroll
  for (int j = 0; j < (NSTW + THREADS - 1) / THREADS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    if (e < NSTW) stw[e] = __ldg(twiddle + stage_twiddle(e));
  }
  stage<WIN>(win, window);
  stage<NMELS * 3>(band, bands);
  stage<MAX_WEIGHTS>(weight, band_weights, n_weights);
  __syncthreads();
  if (!active) return;  // whole warps only: no block barrier below

  float2* z = zbuf[warp];
  float* power = pbuf[warp];

  // z[n] = x[2n] + i x[2n+1]: the windowed frame, zero-padded, is z's
  // floats (slot n at swz(n))
  float* zf = reinterpret_cast<float*>(z);
#pragma unroll
  for (int j = 0; j < NFFT / LANES; ++j) {
    const int n = lane + j * LANES;
    zf[2 * swz(n >> 1) + (n & 1)] = j < SAMPLES && n < WIN ? raw[j] * win[n] : 0.f;
  }
  __syncwarp();

  // 256-point complex FFT, radix-4 Stockham: stage s merges sub-transforms
  // of length p = 4^s. Each lane reads its two butterflies' eight inputs,
  // the warp syncs, and the lane writes their outputs in place.
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int p = 1 << (2 * s);
    float2 v[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int r = 0; r < 4; ++r) v[h][r] = z[swz(lane + h * LANES + r * QUARTER)];
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + h * LANES;
      const int k = i & (p - 1);
      const float2 a = v[h][0];
      float2 bb = v[h][1], c = v[h][2], d = v[h][3];
      if (s > 0) {
        const float2* w = stw + p - 4 + k;
        bb = cmul(bb, w[0]);
        c = cmul(c, w[p]);
        d = cmul(d, w[2 * p]);
      }
      const float2 s0 = make_float2(a.x + c.x, a.y + c.y);
      const float2 s1 = make_float2(a.x - c.x, a.y - c.y);
      const float2 s2 = make_float2(bb.x + d.x, bb.y + d.y);
      const float2 s3 = make_float2(bb.y - d.y, d.x - bb.x);  // -i (bb - d)
      const int j = (i - k) * 4 + k;
      z[swz(j)] = make_float2(s0.x + s2.x, s0.y + s2.y);
      z[swz(j + p)] = make_float2(s1.x + s3.x, s1.y + s3.y);
      z[swz(j + 2 * p)] = make_float2(s0.x - s2.x, s0.y - s2.y);
      z[swz(j + 3 * p)] = make_float2(s1.x - s3.x, s1.y - s3.y);
    }
    __syncwarp();
  }

  // split step: with Z = FFT256(z), E = (Z[k] + conj Z[-k]) / 2 and
  // O = (Z[k] - conj Z[-k]) / 2i are the even and odd samples' spectra and
  // X[k] = E + exp(-2 pi i k / 512) O
#pragma unroll
  for (int q = 0; q < (NFREQ + LANES - 1) / LANES; ++q) {
    const int k = lane + q * LANES;
    if (k >= NFREQ) break;
    const float2 a = z[swz(k & (NZ - 1))], c = z[swz((NZ - k) & (NZ - 1))];
    const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
    const float2 o = make_float2(0.5f * (a.y + c.y), 0.5f * (c.x - a.x));
    const float2 w = cmul(o, tw[k]);
    const float xr = e.x + w.x, xi = e.y + w.y;
    power[k] = fmaf(xr, xr, xi * xi);
  }
  __syncwarp();

  // mel m sums its band: bins band[m].first .. + count, weights from
  // weight[band[m].offset], in bin order
#pragma unroll
  for (int q = 0; q < (NMELS + LANES - 1) / LANES; ++q) {
    const int m = lane + q * LANES;
    if (m >= NMELS) break;
    const int first = band[3 * m], count = band[3 * m + 1];
    const float* w = weight + band[3 * m + 2];
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < count; ++j) acc = fmaf(power[first + j], w[j], acc);
    out[(size_t)f * NMELS + m] = logf(acc + eps);
  }
}

}  // namespace

// pre: f32 [B, N]; window: f32 [400]; twiddle: f32 [512, 2] (cos, -sin of
// 2 pi m / 512); bands: int32 [80, 3] (first bin, bin count, offset into
// band_weights); band_weights: f32 [n_weights], n_weights <= 514; out: f32
// [B, T, 80] with T >= 1 frames; all contiguous on one device. Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int tilawa_log_mel(const void* pre, const void* window, const void* twiddle,
                              const void* bands, const void* band_weights, void* out,
                              int B, int N, int T, int n_weights, float eps, void* stream) {
  if (n_weights > MAX_WEIGHTS) return static_cast<int>(cudaErrorInvalidValue);
  const int frames = B * T;
  const int blocks = (frames + WARPS - 1) / WARPS;
  log_mel_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), static_cast<const float*>(window),
      static_cast<const float2*>(twiddle), static_cast<const int*>(bands),
      static_cast<const float*>(band_weights), static_cast<float*>(out), N, T, frames,
      n_weights, eps);
  return static_cast<int>(cudaGetLastError());
}
