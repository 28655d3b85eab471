// CTC training loss for Hopper (sm_90a): optax.ctc_loss per row and its
// input gradient.
//
// Replaces optax.ctc_loss under jax.value_and_grad, an XLA lax.scan over
// frames and its autodiff (no Pallas kernel), as the JAX package trains
// with it: tilawa_tpu/train/train.py:53 ctc_loss_fn, distill.py:45
// _ctc_per_token, fit_report.py:64. Launched by tilawa_tpu_torch/ops/ctc.py
// (CTCLoss). For every row b (x[b] [T, V] f32, enc_len[b] frames, labels
// tokens[b, :L], right-padded to N) with lp = log_softmax(x) (optax
// normalizes its input again), blank states phi[0..L], label states
// emit[0..L-1], log(0) = LOG_EPS = -1e5, phi[0] = 0 at the start, a frame t
// < enc_len[b] is
//
//   pp[0] = phi[0];  pp[k] = lae(phi[k], emit[k-1] + c1[k-1])
//   emit[k] = lae(pp[k] + lp[t, tok[k]], emit[k] + lp[t, tok[k]])
//   phi[0] = pp[0] + lp[t, blank]
//   phi[k] = lae(pp[k] + lp[t, blank], (emit[k-1] + lp[t, blank]) + c2[k-1])
//
// (c1 = LOG_EPS * repeat, c2 = LOG_EPS * (1 - repeat), repeat[k] = tok[k] ==
// tok[k + 1] over the padded row, 0 at its last column; lae = torch's
// logaddexp, ctc_logaddexp.cuh) and loss[b] = -lae(phi[L], emit[L-1]) (-phi[0]
// at L = 0): finite where the labels need more frames than the row has. The
// gradient is reverse-mode through the same recursion, as autodiff takes
// it: each lae(a, b) = out hands the adjoint of out to a and b weighted by
// exp(a - out) and exp(b - out). The adjoints (probabilities, <= 1) of the
// emissions at frame t, gamma, give d/dx[b, t, v] = g[b] * (exp(lp[t, v]) *
// sum gamma - gamma[v]), 0 at padded frames. Every operation is the plain
// version's (ops/ctc.py ctc_loss_plain, ctc_loss_grad_plain) in its order,
// IEEE expf/logf/log1pf, no contraction of a product into a sum.
//
// Two launches of the library, four kernels:
//   forward   normalize   a warp a frame (the grid covers every live frame):
//                         max and log-sum-exp over V (coalesced), then the
//                         emissions lp at the blank and at each label into a
//                         [B, T, N + 1] workspace;
//             alpha       a block a row, one state pair (phi[k], emit[k]) a
//                         thread, a frame at a time, storing the states of
//                         every frame ([B, T, N + 1] pairs) for the backward;
//   backward  beta        a block a row, the adjoints from the row's last
//                         frame down, writing each frame's (label, blank)
//                         occupations gamma ([B, T, N + 1] pairs) and each
//                         label's next position holding the same token;
//             gradient    a block a frame: the frame's sum of gamma, its V
//                         posteriors in shared memory (a label's summed over
//                         its positions in increasing k), the dense row.
//
// What bounds it on the H100: bytes on paper ([B, T, V] f32 read twice and
// written once: the biggest training batch moves some 20 MB, a few us), but
// in fact the dependent chain of a frame in each direction, as in the
// lattice scorer (ctc_lattice.cu): state k at frame t needs state k-1 at
// t-1. The design keeps the chain short:
// - forward: thread k gets emit[k-1] from its left neighbour (a shuffle in a
//   warp, a two-frame shared slot across warps, one named barrier a frame)
//   and runs two dependent lae's; its emissions come from a register ring
//   FWD_RING frames ahead (loads from HBM), phi's lae is off the chain;
// - backward: every weight depends only on the stored forward states, so
//   the six expf's of a state are off the chain; on it are two products and
//   sums and the adjoint handed to the left neighbour (shuffle and slot
//   again);
// - normalizer and gradient epilogue are memory-bound passes over all
//   frames at once, off the chains.
// No float atomics anywhere: every sum has a fixed order (warp and block
// trees, a label's positions in increasing k), so two runs are bitwise
// equal. A row's frames past its enc_len are not read (the epilogue writes
// their zeros). One block holds a row, so N + 1 <= 1024 state pairs (the
// wrapper raises past that; the port's training labels are shorter); a
// launch allocates nothing and never synchronizes with the host: lengths are
// read from device memory by each block. A length outside [0, N] gives a
// NaN loss and gradient row; so does a label outside the vocabulary.

#include <cuda_runtime.h>

#include "ctc_logaddexp.cuh"   // log1pf_flat, lae, quiet_nan, named barriers

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;  // state pairs a row: one a thread, one block a row
constexpr int MAX_WARPS = MAX_THREADS / 32;
// frames of emissions the forward keeps in flight, and of loads the backward
// keeps in flight (five a frame: a state pair, the left label state, two
// emissions); a block of 1024 threads leaves 64 registers a thread
constexpr int FWD_RING = 8;
constexpr int BWD_RING = 4;
constexpr int NORM_WARPS = 8;      // frames a normalizer block
constexpr int GRAD_THREADS = 256;
constexpr int MAX_VOCAB = 8192;    // the epilogue's V posteriors in shared memory
constexpr int BAR = 1;             // the chain's named barrier
constexpr float LOG_EPS = -1e5f;   // optax.ctc_loss's log(0)

struct Args {
  const float* x;
  long long row_stride, t_stride;
  int B, T, V;
  const int* enc_len;
  const int* tokens;  // [B, N]
  const int* lens;
  int N, blank;
  float2* norm;       // [B, T]: the frame's max and log of its shifted sum
  float* em;          // [B, T, N + 1]: lp at each label, at the blank last
  float2* alpha;      // [B, T, N + 1]: (phi[k], emit[k]) after frame t
  float* loss;        // [B]
  const float* grad_loss;  // [B]
  float2* gam;        // [B, T, N + 1]: (label, blank) occupations at frame t
  int2* link;         // [B, N]: (next position with the same token or -1, first)
  float* grad;        // [B, T, V]
};

__device__ __forceinline__ int frames(const Args& a, int b) {
  return min(max(a.enc_len[b], 0), a.T);
}

__device__ __forceinline__ bool bad_len(const Args& a, int L) { return L < 0 || L > a.N; }

// whether one of the labels at positions k, k + stride, ... below L lies
// outside the vocabulary
__device__ __forceinline__ bool bad_label(const Args& a, const int* tok, int L, int k,
                                          int stride) {
  bool bad = false;
  for (int j = k; j < L; j += stride) bad |= tok[j] < 0 || tok[j] >= a.V;
  return bad;
}

// state k's penalty terms (c1, c2), thread k's own: repeat[k - 1] of the
// padded row (0 at its last column)
__device__ __forceinline__ float2 penalties(const Args& a, const int* tok, int k, int L) {
  const bool rep = k >= 1 && k <= L && k < a.N && tok[k - 1] == tok[k];
  const float r = rep ? 1.0f : 0.0f;
  return make_float2(__fmul_rn(LOG_EPS, r), __fmul_rn(LOG_EPS, __fsub_rn(1.0f, r)));
}

__global__ void __launch_bounds__(32 * NORM_WARPS) ctc_normalize(Args a) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * NORM_WARPS + (threadIdx.x >> 5);
  if (r >= (long long)a.B * a.T) return;
  const int b = (int)(r / a.T), t = (int)(r % a.T);
  if (t >= frames(a, b)) return;
  const float* x = a.x + b * a.row_stride + t * a.t_stride;
  float m = -__int_as_float(0x7f800000);
  for (int v = lane; v < a.V; v += 32) m = fmaxf(m, x[v]);
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  float s = 0.0f;
  for (int v = lane; v < a.V; v += 32) s = __fadd_rn(s, expf(__fsub_rn(x[v], m)));
  for (int o = 16; o; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(FULL, s, o));
  const float ls = logf(__shfl_sync(FULL, s, 0));   // lane 0's sum: one order
  if (lane == 0) a.norm[r] = make_float2(m, ls);
  const int L = a.lens[b];
  const int* tok = a.tokens + (long long)b * a.N;
  float* em = a.em + r * (a.N + 1);
  for (int n = lane; n < a.N; n += 32) {
    const int k = tok[n];
    float e = 0.0f;  // a position past the labels: its state is never read
    if (n < L) e = k >= 0 && k < a.V ? __fsub_rn(__fsub_rn(x[k], m), ls) : quiet_nan();
    em[n] = e;
  }
  if (lane == 0) em[a.N] = __fsub_rn(__fsub_rn(x[a.blank], m), ls);
}

// the alpha chain of row blockIdx.x: thread k holds phi[k] and emit[k] for
// k <= L (thread L's emit is a dummy that no live state reads); warps past
// state L exit, the others meet at named barrier BAR each frame
__global__ void __launch_bounds__(MAX_THREADS) ctc_alpha(Args a) {
  __shared__ float inbound[2 * MAX_WARPS];
  const int b = blockIdx.x, k = threadIdx.x, lane = k & 31, w = k >> 5;
  const int L = a.lens[b];
  if (bad_len(a, L)) {
    if (k == 0) a.loss[b] = quiet_nan();
    return;
  }
  const int g = (L + 32) / 32;  // warps for states 0..L
  if (w >= g) return;
  const int* tok = a.tokens + (long long)b * a.N;
  const bool bad = bad_label(a, tok, L, k, 32 * g);
  if (g == 1 ? __any_sync(FULL, bad) : named_any(BAR, 32 * g, bad)) {
    if (k == 0) a.loss[b] = quiet_nan();  // a label outside the vocabulary: no loss
    return;
  }
  const int t_run = frames(a, b);
  const float2 c = penalties(a, tok, k, L);
  const long long fs = a.N + 1;  // a frame's stride in em and alpha
  const float* emb = a.em + (long long)b * a.T * fs;
  float2* out = a.alpha + (long long)b * a.T * fs + k;
  const bool label = k < L, stored = k <= L;  // past L: dummies, never stored
  float phi = k == 0 ? 0.0f : LOG_EPS;
  float emit = LOG_EPS;

  float rb[FWD_RING], rt[FWD_RING];  // slot f: the frame that round position f uses
#pragma unroll
  for (int f = 0; f < FWD_RING; ++f) {
    const float* row = emb + (long long)min(f, max(t_run - 1, 0)) * fs;
    rb[f] = t_run > 0 ? __ldg(row + a.N) : 0.0f;
    rt[f] = t_run > 0 && label ? __ldg(row + k) : 0.0f;
  }
  auto publish = [&](int par) {
    if (lane == 31 && w + 1 < g) inbound[par * MAX_WARPS + w + 1] = emit;
  };
  auto receive = [&](int par) {  // emit[k - 1] of the previous frame
    float up = __shfl_up_sync(FULL, emit, 1);
    if (lane == 0) up = w == 0 ? LOG_EPS : inbound[par * MAX_WARPS + w];
    return up;
  };

  publish(0);
  for (int t0 = 0; t0 < t_run; t0 += FWD_RING) {
#pragma unroll
    for (int f = 0; f < FWD_RING; ++f) {
      const int t = t0 + f;
      if (t >= t_run) break;
      if (g > 1) named_sync(BAR, 32 * g);
      const float left = receive(f & 1);  // t has the parity of f
      const float lb = rb[f], le = rt[f];
      const float pp = k == 0 ? phi : lae(phi, __fadd_rn(left, c.x));
      const float next_emit = lae(__fadd_rn(pp, le), __fadd_rn(emit, le));
      const float next_phi = k == 0 ? __fadd_rn(pp, lb)
                                    : lae(__fadd_rn(pp, lb),
                                          __fadd_rn(__fadd_rn(left, lb), c.y));
      emit = next_emit;
      phi = next_phi;
      if (stored) out[t * fs] = make_float2(phi, emit);
      const float* row = emb + (long long)min(t + FWD_RING, t_run - 1) * fs;
      rb[f] = __ldg(row + a.N);
      rt[f] = label ? __ldg(row + k) : 0.0f;
      publish((f + 1) & 1);
    }
  }
  if (g > 1) named_sync(BAR, 32 * g);
  const float left = receive(t_run & 1);
  if (k == L) a.loss[b] = -(L == 0 ? phi : lae(phi, left));
}

// the adjoint chain of row blockIdx.x, from its last frame down: thread k
// holds the adjoints of phi[k] and emit[k] after the frame and hands state
// k - 1 the part of emit[k - 1]'s adjoint that flows through state k
__global__ void __launch_bounds__(MAX_THREADS) ctc_beta(Args a) {
  __shared__ float inbound[2 * MAX_WARPS];
  __shared__ int stok[MAX_THREADS];
  const int b = blockIdx.x, k = threadIdx.x, lane = k & 31, w = k >> 5;
  const int L = a.lens[b];
  if (bad_len(a, L)) return;  // the epilogue writes the row's NaN
  const int g = (L + 32) / 32;
  if (w >= g) return;
  const int* tok = a.tokens + (long long)b * a.N;
  const bool bad = bad_label(a, tok, L, k, 32 * g);  // alpha stored nothing: no adjoints
  if (g == 1 ? __any_sync(FULL, bad) : named_any(BAR, 32 * g, bad)) return;
  if (k < L) stok[k] = tok[k];
  if (g > 1) named_sync(BAR, 32 * g);
  else __syncwarp();
  if (k < L) {  // the next position with label k's token, and whether k is its first
    const int me = stok[k];
    int next = -1;
    for (int j = k + 1; j < L && next < 0; ++j) next = stok[j] == me ? j : -1;
    bool first = true;
    for (int j = 0; j < k && first; ++j) first = stok[j] != me;
    a.link[(long long)b * a.N + k] = make_int2(next, first ? 1 : 0);
  }
  const int t_run = frames(a, b);
  const bool live = k <= L;  // the row's states; past them the adjoints stay 0
  const float2 c = penalties(a, tok, k, L);
  const long long fs = a.N + 1;
  const float2* al = a.alpha + (long long)b * a.T * fs;
  const float* emb = a.em + (long long)b * a.T * fs;
  float2* gm = a.gam + (long long)b * a.T * fs + k;
  const float2 init = make_float2(k == 0 ? 0.0f : LOG_EPS, LOG_EPS);
  // the states (phi, emit) of state j after frame t (t = -1: the start)
  auto state = [&](int t, int j) -> float2 {
    return t < 0 ? make_float2(j == 0 ? 0.0f : LOG_EPS, LOG_EPS) : al[t * fs + j];
  };

  // the final lae, lae(phi[L], emit[L-1]), in threads L and L - 1 alike
  float g_phi = 0.0f, g_emit = 0.0f;
  float2 cur = init;
  if (live) {
    cur = state(t_run - 1, k);
    if (k == L && L == 0) g_phi = 1.0f;
    if (L > 0 && (k == L || k == L - 1)) {
      const float p = state(t_run - 1, L).x, e = state(t_run - 1, L - 1).y;
      const float last = lae(p, e);
      if (k == L) g_phi = expf(__fsub_rn(p, last));
      else g_emit = expf(__fsub_rn(e, last));
    }
  }

  // ring slot f: frame t's inputs (the states before it, emit[k - 1] before
  // it, its two emissions)
  float rp[BWD_RING], re[BWD_RING], rl[BWD_RING], rt[BWD_RING], rb[BWD_RING];
  auto load = [&](int f, int t) {
    float2 prev = init;
    float left = LOG_EPS, le = 0.0f, lb = 0.0f;
    if (live && t >= 0) {
      prev = state(t - 1, k);
      if (k >= 1) left = state(t - 1, k - 1).y;
      lb = emb[t * fs + a.N];
      if (k < L) le = emb[t * fs + k];
    }
    rp[f] = prev.x;
    re[f] = prev.y;
    rl[f] = left;
    rt[f] = le;
    rb[f] = lb;
  };
#pragma unroll
  for (int f = 0; f < BWD_RING; ++f) load(f, t_run - 1 - f);

  for (int t0 = t_run - 1; t0 >= 0; t0 -= BWD_RING) {
#pragma unroll
    for (int f = 0; f < BWD_RING; ++f) {
      const int t = t0 - f;
      if (t < 0) break;
      const float p_prev = rp[f], e_prev = re[f], left = rl[f], le = rt[f], lb = rb[f];
      // the weights, from stored states only: off the chain
      const float pp = k == 0 ? p_prev : lae(p_prev, __fadd_rn(left, c.x));
      const float w_a = expf(__fsub_rn(__fadd_rn(pp, le), cur.y));
      const float w_b = expf(__fsub_rn(__fadd_rn(e_prev, le), cur.y));
      const float w_c = k == 0 ? 1.0f : expf(__fsub_rn(__fadd_rn(pp, lb), cur.x));
      const float w_d = k == 0 ? 0.0f
                               : expf(__fsub_rn(__fadd_rn(__fadd_rn(left, lb), c.y), cur.x));
      const float w_p = k == 0 ? 1.0f : expf(__fsub_rn(p_prev, pp));
      const float w_l = k == 0 ? 0.0f : expf(__fsub_rn(__fadd_rn(left, c.x), pp));
      // the chain
      const float g_a = __fmul_rn(g_emit, w_a);
      const float g_pp = __fadd_rn(g_a, __fmul_rn(g_phi, w_c));
      if (live) {
        const float lab = k < L ? __fadd_rn(g_a, __fmul_rn(g_emit, w_b)) : 0.0f;
        const float blk = k == 0 ? g_phi
                                 : __fadd_rn(__fmul_rn(g_phi, w_c), __fmul_rn(g_phi, w_d));
        gm[t * fs] = make_float2(lab, blk);
      }
      const float send = __fadd_rn(__fmul_rn(g_phi, w_d), __fmul_rn(g_pp, w_l));
      g_phi = __fmul_rn(g_pp, w_p);
      if (g > 1 && lane == 0 && w > 0) inbound[(f & 1) * MAX_WARPS + w - 1] = send;
      if (g > 1) named_sync(BAR, 32 * g);
      float from_right = __shfl_down_sync(FULL, send, 1);
      if (lane == 31) from_right = w + 1 < g ? inbound[(f & 1) * MAX_WARPS + w] : 0.0f;
      g_emit = __fadd_rn(__fmul_rn(g_emit, w_b), from_right);
      cur = make_float2(p_prev, e_prev);
      load(f, t - BWD_RING);
    }
  }
}

// frame blockIdx.x of row blockIdx.y: d/dx = g * (exp(lp) * sum gamma - gamma)
__global__ void __launch_bounds__(GRAD_THREADS) ctc_gradient(Args a) {
  extern __shared__ float post[];  // [V]: the frame's posterior of each class
  __shared__ float lab[MAX_THREADS];
  __shared__ int next[MAX_THREADS];
  __shared__ float sums[2][GRAD_THREADS / 32];
  const int t = blockIdx.x, b = blockIdx.y, i = threadIdx.x, lane = i & 31, w = i >> 5;
  float* out = a.grad + ((long long)b * a.T + t) * a.V;
  const int L = a.lens[b];
  const int* tok = a.tokens + (long long)b * a.N;
  // a NaN row where the forward gave a NaN loss (a length outside [0, N], a
  // label outside the vocabulary: beta wrote no gamma)
  const bool bad = __syncthreads_or(bad_len(a, L) || bad_label(a, tok, L, i, GRAD_THREADS));
  if (bad || t >= frames(a, b)) {
    const float fill = bad ? quiet_nan() : 0.0f;
    for (int v = i; v < a.V; v += GRAD_THREADS) out[v] = fill;
    return;
  }
  const long long fs = a.N + 1;
  const float2* gm = a.gam + ((long long)b * a.T + t) * fs;
  const int2* ln = a.link + (long long)b * a.N;
  float s_lab = 0.0f, s_blk = 0.0f;
  for (int k = i; k <= L; k += GRAD_THREADS) {
    const float2 q = gm[k];
    if (k < L) {
      lab[k] = q.x;
      next[k] = ln[k].x;
      s_lab = __fadd_rn(s_lab, q.x);
    }
    s_blk = __fadd_rn(s_blk, q.y);
  }
  for (int o = 16; o; o >>= 1) {
    s_lab = __fadd_rn(s_lab, __shfl_xor_sync(FULL, s_lab, o));
    s_blk = __fadd_rn(s_blk, __shfl_xor_sync(FULL, s_blk, o));
  }
  if (lane == 0) {
    sums[0][w] = s_lab;
    sums[1][w] = s_blk;
  }
  for (int v = i; v < a.V; v += GRAD_THREADS) post[v] = 0.0f;
  __syncthreads();
  s_lab = 0.0f;
  s_blk = 0.0f;
  for (int j = 0; j < GRAD_THREADS / 32; ++j) {  // every thread, one order
    s_lab = __fadd_rn(s_lab, sums[0][j]);
    s_blk = __fadd_rn(s_blk, sums[1][j]);
  }
  const float total = __fadd_rn(s_lab, s_blk);
  if (i == 0) post[a.blank] = s_blk;
  __syncthreads();
  for (int k = i; k < L; k += GRAD_THREADS) {
    const int v = tok[k];
    if (ln[k].y) {  // a token's first position sums its chain
      float acc = lab[k];
      for (int j = next[k]; j >= 0; j = next[j]) acc = __fadd_rn(acc, lab[j]);
      post[v] = v == a.blank ? __fadd_rn(post[v], acc) : acc;
    }
  }
  __syncthreads();
  const float2 nm = a.norm[(long long)b * a.T + t];
  const float gb = a.grad_loss[b];
  const float* x = a.x + b * a.row_stride + t * a.t_stride;
  for (int v = i; v < a.V; v += GRAD_THREADS) {
    const float p = expf(__fsub_rn(__fsub_rn(x[v], nm.x), nm.y));
    out[v] = __fmul_rn(gb, __fsub_rn(__fmul_rn(p, total), post[v]));
  }
}

int block_threads(int N) { return (N + 1 + 31) / 32 * 32; }

bool fits(int B, int T, int V, int N, int blank) {
  return B >= 0 && T >= 0 && V >= 1 && V <= MAX_VOCAB && N >= 0 && N + 1 <= MAX_THREADS &&
         blank >= 0 && blank < V && B <= 65535;
}

Args make_args(const float* x, long long row_stride, long long t_stride, int B, int T, int V,
               const int* enc_len, const int* tokens, const int* lens, int N, int blank) {
  Args a = {};
  a.x = x;
  a.row_stride = row_stride;
  a.t_stride = t_stride;
  a.B = B;
  a.T = T;
  a.V = V;
  a.enc_len = enc_len;
  a.tokens = tokens;
  a.lens = lens;
  a.N = N;
  a.blank = blank;
  return a;
}

}  // namespace

// x [B, T, V] f32 (row b's frame t at x + b * row_stride + t * t_stride,
// classes contiguous); enc_len, tokens [B, N] and lens int32 in device
// memory; workspaces norm [B, T, 2], em [B, T, N + 1], alpha [B, T, N + 1,
// 2] f32; loss [B]. Normalizer, then the alpha chain. Returns
// cudaErrorInvalidValue for a shape the kernels do not take (N + 1 > 1024
// state pairs, V > 8192, the blank outside V, B > 65535), else the
// launches' error.
extern "C" int tilawa_ctc_loss_forward(const float* x, long long row_stride, long long t_stride,
                                       int B, int T, int V, const int* enc_len,
                                       const int* tokens, const int* lens, int N, int blank,
                                       float* norm, float* em, float* alpha, float* loss,
                                       void* stream) {
  if (!fits(B, T, V, N, blank)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  Args a = make_args(x, row_stride, t_stride, B, T, V, enc_len, tokens, lens, N, blank);
  a.norm = reinterpret_cast<float2*>(norm);
  a.em = em;
  a.alpha = reinterpret_cast<float2*>(alpha);
  a.loss = loss;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * T;
  if (rows > 0) {
    ctc_normalize<<<(unsigned)((rows + NORM_WARPS - 1) / NORM_WARPS), 32 * NORM_WARPS, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ctc_alpha<<<B, block_threads(N), 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The forward's arguments, then the upstream gradient grad_loss [B] f32, the
// forward's workspaces, gam [B, T, N + 1, 2] f32, link [B, max(N, 1), 2]
// int32 and the gradient [B, T, V] f32 (contiguous). The adjoint chain, then
// the epilogue (a frame a block, V floats of dynamic shared memory).
extern "C" int tilawa_ctc_loss_backward(const float* x, long long row_stride,
                                        long long t_stride, int B, int T, int V,
                                        const int* enc_len, const int* tokens, const int* lens,
                                        int N, int blank, const float* grad_loss,
                                        const float* norm, const float* em, const float* alpha,
                                        float* gam, int* link, float* grad, void* stream) {
  if (!fits(B, T, V, N, blank)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaSuccess;
  Args a = make_args(x, row_stride, t_stride, B, T, V, enc_len, tokens, lens, N, blank);
  a.grad_loss = grad_loss;
  a.norm = reinterpret_cast<float2*>(const_cast<float*>(norm));
  a.em = const_cast<float*>(em);
  a.alpha = reinterpret_cast<float2*>(const_cast<float*>(alpha));
  a.gam = reinterpret_cast<float2*>(gam);
  a.link = reinterpret_cast<int2*>(link);
  a.grad = grad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ctc_beta<<<B, block_threads(N), 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ctc_gradient<<<dim3(T, B), GRAD_THREADS, V * sizeof(float), s>>>(a);
  return (int)cudaGetLastError();
}
