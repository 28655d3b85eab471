// CTC training loss for Hopper (sm_90a): optax.ctc_loss per row and its
// input gradient, each row's chains in one of three layouts sized to it.
//
// Replaces optax.ctc_loss under jax.value_and_grad, an XLA lax.scan over
// frames and its autodiff (no Pallas kernel), as the JAX package trains
// with it: tilawa_tpu/train/train.py:53 ctc_loss_fn, distill.py:45
// _ctc_per_token, fit_report.py:64. Launched by tilawa_tpu_torch/ops/ctc.py
// (CTCLoss), laid out by its loss_plan. For every row b (x[b] [T, V] f32,
// enc_len[b] frames, labels tokens[b, :L], right-padded to N) with lp =
// log_softmax(x) (optax normalizes its input again), blank states
// phi[0..L], label states emit[0..L-1], log(0) = LOG_EPS = -1e5, phi[0] = 0
// at the start, a frame t < enc_len[b] is
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
//                         [B, T, N + 1] workspace; and a block a row that
//                         sorts the row's labels by (token, position) in
//                         shared memory (bitonic) to link each label to the
//                         next position of its token, for the epilogue;
//             alpha       the chain a row on the plan's layout, storing for
//                         every frame and state what the backward reads of
//                         it ([B, T, N + 1] records: the states after the
//                         frame, the left label state before it and the
//                         frame's pp);
//   backward  beta        the adjoint chain a row on the same layout, from
//                         the row's last frame down, writing each frame's
//                         (label, blank) occupations gamma ([B, T, N + 1]
//                         pairs);
//             gradient    a block a frame: the frame's sum of gamma, its V
//                         posteriors in shared memory (a label's summed over
//                         its positions in increasing k), the dense row.
//
// What bounds it on the H100: bytes on paper ([B, T, V] f32 read twice and
// written once: the biggest training batch moves some 20 MB, a few us), but
// in fact the dependent chain of a frame in each direction, as in the
// lattice scorer (ctc_lattice.cu): state k at frame t needs state k-1 at
// t-1 (forward) or k+1 at t+1 (backward), so a row takes its frames times
// two dependent logaddexps, plus whatever a frame adds to that chain. One
// state pair (phi[k], emit[k]) a thread; what a frame adds is the exchange
// with the neighbour (a shuffle in a warp, a two-frame shared slot across
// warps) and, past one warp, a barrier of the warps that exchange. Its cost
// grows with the warps on it, so the layouts keep them few:
// - "warp" (N + 1 <= 32): one warp a row, shuffles only, no barrier;
// - "group": one block a row, the row's own warps (its L sets them, the
//   others exit) on named barrier BAR each frame;
// - "cluster": a thread-block cluster of C CTAs (2-16) a row, each a
//   contiguous slice of the states plus a halo warp of the H states beside
//   it that a neighbour owns: a CTA's barrier spans its few warps, and the
//   halo is refreshed from its owner through distributed shared memory
//   every H frames, one cluster barrier, before the wrong value that enters
//   at its far end reaches the slice (run_alpha, run_beta). The forward's
//   halo lies to the left of the slice, the backward's to the right
//   (adjoints flow from state k to k - 1). Only the CTA that owns a state
//   stores it, so both chains stay bitwise the plain version's.
// On the forward's chain are the two logaddexps (its emissions come from a
// register ring FWD_RING frames ahead, phi's lae is off the chain); on the
// backward's the adjoints' products and sums: every weight depends only on
// what the forward stored, so a frame's six weights (six expf, no
// logaddexp: the forward's pp is in its record) are computed one frame
// ahead, while the frame before waits at its barrier, from a ring of loads
// BWD_RING frames ahead: three a frame, the forward's 16-byte record of the
// state and the frame's two emissions (a thread keeps few loads in flight
// well: with five a frame, and pp recomputed, the backward waited on them).
// No float atomics anywhere: every sum has a fixed order (warp and block
// trees, a label's positions in increasing k), so two runs are bitwise
// equal, whatever the layout. A row's frames past its enc_len are not read
// (the epilogue writes their zeros). Up to MAX_LABELS labels (16 CTAs of
// MAX_THREADS threads, their halos' included); a launch allocates nothing
// and never synchronizes with the host: lengths are read from device
// memory by each block. A length outside [0, N] gives a NaN loss and
// gradient row; so does a label outside the vocabulary.

#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ctc_logaddexp.cuh"   // log1pf_flat, lae, quiet_nan, named and cluster barriers

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
// threads a block: a group's warps, or a cluster CTA's with its halo warp;
// 512 leaves a thread 128 registers for its state pair and its rings
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int H = 32;            // a cluster CTA's halo states, and frames between refreshes
constexpr int MAX_CLUSTER = 16;  // the H100's limit, past the portable 8
constexpr int MAX_LABELS = MAX_CLUSTER * (MAX_THREADS - H) - 1;
// frames of emissions the forward keeps in flight, and of loads the backward
// keeps in flight (three a frame: a state's record and two emissions)
constexpr int FWD_RING = 8;
constexpr int BWD_RING = 12;
constexpr int NORM_WARPS = 8;      // frames a normalizer block
constexpr int GRAD_THREADS = 256;
constexpr int MAX_VOCAB = 8192;    // the epilogue's V posteriors in shared memory
constexpr int POS_BITS = 13;       // a label's position in a sort key: MAX_LABELS < 2^13
constexpr int BAR = 1;             // the chain's named barrier
constexpr float LOG_EPS = -1e5f;   // optax.ctc_loss's log(0)

static_assert(MAX_LABELS < (1 << POS_BITS) && MAX_VOCAB <= (1 << POS_BITS), "sort keys");
static_assert(FWD_RING % 2 == 0 && BWD_RING % 2 == 0 && BWD_RING >= 4,
              "slot parity is fixed within a ring; the backward reads two frames ahead");

enum Sync { WARP, GROUP, CLUSTER };

struct Args {
  const float* x;
  long long row_stride, t_stride;
  int B, T, V;
  const int* enc_len;
  const int* tokens;  // [B, N]
  const int* lens;
  int N, blank;
  int warps;          // a block's warps (a cluster CTA's, its halo's included)
  int cluster;        // CTAs a row
  float2* norm;       // [B, T]: the frame's max and log of its shifted sum
  float* em;          // [B, T, N + 1]: lp at each label, at the blank last
  float4* alpha;      // [B, T, N + 1]: (phi[k], emit[k]) after frame t, emit[k - 1]
                      // before it and the frame's pp[k]
  int2* link;         // [B, N]: (next position with the same token or -1, first)
  float* loss;        // [B]
  const float* grad_loss;  // [B]
  float2* gam;        // [B, T, N + 1]: (label, blank) occupations at frame t
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

// state k's penalty terms (c1, c2): repeat[k - 1] of the padded row (0 at
// its last column)
__device__ __forceinline__ float2 penalties(const Args& a, const int* tok, int k, int L) {
  const bool rep = k >= 1 && k <= L && k < a.N && tok[k - 1] == tok[k];
  const float r = rep ? 1.0f : 0.0f;
  return make_float2(__fmul_rn(LOG_EPS, r), __fmul_rn(LOG_EPS, __fsub_rn(1.0f, r)));
}

// a cluster CTA's slice of a row of L labels over n CTAs: ceil((L + 1) / n)
// states in whole warps, at least a halo's
__host__ __device__ __forceinline__ int slice_states(int L, int n) {
  const int s = ((L + n) / n + 31) / 32 * 32;
  return s > H ? s : H;
}

// row b's links: its labels sorted by (token, position) in shared memory,
// each label's next position with the same token (-1 at the token's last)
// and whether it is the token's first
__device__ void row_links(const Args& a, int b, int* keys) {
  const int L = a.lens[b];
  if (bad_len(a, L) || L == 0) return;  // no gradient reads them
  const int* tok = a.tokens + (long long)b * a.N;
  const int n = blockDim.x, pos = (1 << POS_BITS) - 1;
  int m = 1;
  while (m < L) m <<= 1;
  for (int i = threadIdx.x; i < m; i += n) {
    keys[i] = i < L ? (min(max(tok[i], 0), MAX_VOCAB - 1) << POS_BITS) | i : INT_MAX;
  }
  __syncthreads();
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < m / 2; i += n) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const int p = keys[lo], q = keys[hi];
        if ((p > q) == ((lo & size) == 0)) {
          keys[lo] = q;
          keys[hi] = p;
        }
      }
      __syncthreads();
    }
  }
  int2* link = a.link + (long long)b * a.N;
  for (int i = threadIdx.x; i < L; i += n) {
    const int key = keys[i], v = key >> POS_BITS;
    const int next = i + 1 < L && keys[i + 1] >> POS_BITS == v ? keys[i + 1] & pos : -1;
    const bool first = i == 0 || keys[i - 1] >> POS_BITS != v;
    link[key & pos] = make_int2(next, first ? 1 : 0);
  }
}

// blocks below frame_blocks: a warp a frame; the B blocks after them: a row's links
__global__ void __launch_bounds__(32 * NORM_WARPS) ctc_normalize(Args a, int frame_blocks) {
  extern __shared__ int keys[];  // a power of two >= N sort keys
  if ((int)blockIdx.x >= frame_blocks) {
    row_links(a, blockIdx.x - frame_blocks, keys);
    return;
  }
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

// The alpha chain of row b on one layout: thread i of a group of g warps
// holds state pair k = base + i (a dummy past L: no live state reads it) and
// stores it where it owns it (lo <= k < hi, k <= L); the thread that owns
// blank state L writes the loss. `in` holds two frames of boundary slots:
// in[par * MAX_WARPS + w] is emit[k - 1] just before warp w's first state
// at the frame of parity par, written by warp w - 1.
//
// CLUSTER: the group is one CTA of the row's cluster, and its warp 0 is a
// halo: the H states before its slice [lo, hi), which the previous CTA
// owns. The halo's first state takes LOG_EPS for its left neighbour, so a
// wrong value enters at the halo's left end and moves right one state a
// frame: after H frames it would reach the slice. So after every H frames
// each CTA's last warp writes its states into the next CTA's `halo` slots
// through distributed shared memory, a cluster barrier follows, and the
// halo warp reloads them: every state of a slice is computed from exact
// inputs. The first CTA's halo lies before state 0 and is never read.
template <int SYNC>
__device__ __forceinline__ void run_alpha(const Args& a, int b, int L, const int* tok,
                                          int t_run, int i, int g, int base, int lo, int hi,
                                          float* in, const float2* halo, float2* next_halo,
                                          bool first) {
  const int lane = i & 31, w = i >> 5, k = base + i;
  // the warp whose lane 0 has no left neighbour: state 0's, or the halo
  const bool left_edge = w == 0 || (SYNC == CLUSTER && first && w == 1);
  const bool label = k >= 0 && k < L;
  const bool owned = k >= lo && k < hi && k <= L;
  const float2 c = penalties(a, tok, k, L);
  const long long fs = a.N + 1;  // a frame's stride in em and alpha
  const float* emb = a.em + (long long)b * a.T * fs;
  float4* out = a.alpha + (long long)b * a.T * fs + max(k, 0);
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
    if (SYNC != WARP && lane == 31 && w + 1 < g) in[par * MAX_WARPS + w + 1] = emit;
  };
  auto receive = [&](int par) {  // emit[k - 1] of the previous frame
    float up = __shfl_up_sync(FULL, emit, 1);
    if (lane == 0) up = left_edge ? LOG_EPS : in[par * MAX_WARPS + w];
    return up;
  };
  // after frame x H - 1: the next CTA's halo from this CTA's last warp
  auto refresh = [&](int x, int par) {
    const int slot = (x & 1) * H;  // two exchanges in flight at most
    if (w == g - 1 && next_halo != nullptr) next_halo[slot + lane] = make_float2(phi, emit);
    cluster_arrive();
    cluster_wait();
    if (w == 0 && !first) {
      const float2 s = halo[slot + lane];
      phi = s.x;
      emit = s.y;
      publish(par);
    }
  };

  publish(0);
  for (int t0 = 0; t0 < t_run; t0 += FWD_RING) {
#pragma unroll
    for (int f = 0; f < FWD_RING; ++f) {
      const int t = t0 + f;
      if (t >= t_run) break;
      if (SYNC != WARP) named_sync(BAR, 32 * g);
      const float left = receive(f & 1);  // t has the parity of f
      const float lb = rb[f], le = rt[f];
      // every lane computes every logaddexp and state 0 selects its own
      // values: no branch in the frame, so the compiler interleaves them
      const float pp_k = lae(phi, __fadd_rn(left, c.x));
      const float pp = k == 0 ? phi : pp_k;
      const float next_emit = lae(__fadd_rn(pp, le), __fadd_rn(emit, le));
      const float phi_k = lae(__fadd_rn(pp, lb), __fadd_rn(__fadd_rn(left, lb), c.y));
      const float next_phi = k == 0 ? __fadd_rn(pp, lb) : phi_k;
      emit = next_emit;
      phi = next_phi;
      if (owned) out[t * fs] = make_float4(phi, emit, left, pp);
      const float* row = emb + (long long)min(t + FWD_RING, t_run - 1) * fs;
      rb[f] = __ldg(row + a.N);
      rt[f] = label ? __ldg(row + k) : 0.0f;
      publish((f + 1) & 1);
      if (SYNC == CLUSTER && (t + 1) % H == 0) refresh((t + 1) / H, (f + 1) & 1);
    }
  }
  if (SYNC != WARP) named_sync(BAR, 32 * g);
  const float left = receive(t_run & 1);
  if (k == L && owned) a.loss[b] = -(L == 0 ? phi : lae(phi, left));
}

// "warp" and "group": a block a row, thread k holding state pair k; warps
// past state L exit, the others meet at named barrier BAR each frame
__global__ void __launch_bounds__(MAX_THREADS) ctc_alpha_rows(Args a) {
  __shared__ float inbound[2 * MAX_WARPS];
  const int b = blockIdx.x, i = threadIdx.x, w = i >> 5;
  const int L = a.lens[b];
  if (bad_len(a, L)) {
    if (i == 0) a.loss[b] = quiet_nan();
    return;
  }
  const int g = (L + 32) / 32;  // warps for states 0..L
  if (w >= g) return;
  const int* tok = a.tokens + (long long)b * a.N;
  const bool bad = bad_label(a, tok, L, i, 32 * g);
  if (g == 1 ? __any_sync(FULL, bad) : named_any(BAR, 32 * g, bad)) {
    if (i == 0) a.loss[b] = quiet_nan();  // a label outside the vocabulary: no loss
    return;
  }
  const int t_run = frames(a, b);
  if (g == 1) {
    run_alpha<WARP>(a, b, L, tok, t_run, i, 1, 0, 0, INT_MAX, inbound, nullptr, nullptr, true);
  } else {
    run_alpha<GROUP>(a, b, L, tok, t_run, i, g, 0, 0, INT_MAX, inbound, nullptr, nullptr, true);
  }
}

// "cluster": the C CTAs of cluster b hold row b; CTA r holds the slice
// [r S, (r + 1) S) of its states (S from the row's own L) and, on its
// first warp, the halo before it. Warps past the row's slice keep to the
// halo refreshes' cluster barriers.
__global__ void __launch_bounds__(MAX_THREADS) ctc_alpha_cluster(Args a) {
  __shared__ float inbound[2 * MAX_WARPS];
  __shared__ float2 halo[2 * H];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.cluster, rank = (int)cluster.block_rank();
  const int b = blockIdx.x / n, i = threadIdx.x, w = i >> 5;
  const int L = a.lens[b];  // the same in every CTA of the cluster, and so are the exits
  if (bad_len(a, L)) {
    if (rank == 0 && i == 0) a.loss[b] = quiet_nan();
    return;
  }
  const int* tok = a.tokens + (long long)b * a.N;
  if (__syncthreads_or(bad_label(a, tok, L, i, blockDim.x))) {
    if (rank == 0 && i == 0) a.loss[b] = quiet_nan();
    return;
  }
  const int t_run = frames(a, b);
  const int slice = slice_states(L, n);
  const int g = 1 + slice / 32;  // the halo's warp and the slice's
  float2* next_halo = rank + 1 < n ? cluster.map_shared_rank(halo, rank + 1) : nullptr;
  cluster.sync();  // every CTA is here before any writes into another's halo
  if (w >= g) {
    for (int x = t_run / H; x > 0; --x) {
      cluster_arrive();
      cluster_wait();
    }
    return;
  }
  // after the last refresh's barrier no CTA touches another's shared memory,
  // so each may exit when its own slice is done
  run_alpha<CLUSTER>(a, b, L, tok, t_run, i, g, rank * slice - H, rank * slice,
                     (rank + 1) * slice, inbound, halo, next_halo, rank == 0);
}

// the weights of state k's logaddexps at one frame: each lae(p, q) = out
// hands out's adjoint to p and q weighted exp(p - out) and exp(q - out).
// From the states before the frame (p_prev, e_prev, left = emit[k - 1]),
// its pp, its emissions and the states after it (cur): none is on the
// chain.
struct Weights {
  float a, b, c, d, p, l;
};

__device__ __forceinline__ Weights weights(int k, float2 c, float p_prev, float e_prev,
                                           float left, float pp, float le, float lb,
                                           float2 cur) {
  // every lane computes every exp and state 0 selects its constants: no
  // branch
  const float wc = expf(__fsub_rn(__fadd_rn(pp, lb), cur.x));
  const float wd = expf(__fsub_rn(__fadd_rn(__fadd_rn(left, lb), c.y), cur.x));
  const float wp = expf(__fsub_rn(p_prev, pp));
  const float wl = expf(__fsub_rn(__fadd_rn(left, c.x), pp));
  Weights w;
  w.a = expf(__fsub_rn(__fadd_rn(pp, le), cur.y));
  w.b = expf(__fsub_rn(__fadd_rn(e_prev, le), cur.y));
  w.c = k == 0 ? 1.0f : wc;
  w.d = k == 0 ? 0.0f : wd;
  w.p = k == 0 ? 1.0f : wp;
  w.l = k == 0 ? 0.0f : wl;
  return w;
}

// The adjoint chain of row b from its last frame down, on one layout:
// thread i of a group of g warps holds the adjoints (g_phi, g_emit) of
// state pair k = base + i after the frame and hands state k - 1 the part of
// emit[k - 1]'s adjoint that flows through state k (`send`: a shuffle in a
// warp, across warps the slot in[par * MAX_WARPS + w - 1]); it writes the
// frame's occupations gamma where it owns the state (lo <= k < hi, k <= L).
// The frame's weights were computed during the frame after it, while that
// frame waited at its barrier.
//
// CLUSTER: the group is one CTA of the row's cluster, and its last warp is
// a halo: the H states after its slice, which the next CTA owns. The
// halo's last state takes 0 from its right, so a wrong value enters at the
// halo's right end and moves left one state a frame. So after every H
// frames each CTA's first warp writes its adjoints into the previous CTA's
// `halo` slots through distributed shared memory, a cluster barrier
// follows, and the halo warp reloads them. The last CTA's halo lies past
// state L, where every adjoint is 0: it is never reloaded.
template <int SYNC>
__device__ __forceinline__ void run_beta(const Args& a, int b, int L, const int* tok,
                                         int t_run, int i, int g, int base, int lo, int hi,
                                         float* in, const float2* halo, float2* prev_halo,
                                         bool last) {
  const int lane = i & 31, w = i >> 5, k = base + i;
  const bool live = k <= L;  // the row's states; past them the adjoints stay 0
  const bool owned = live && k >= lo && k < hi;
  const float2 c = penalties(a, tok, k, L);
  const long long fs = a.N + 1;
  const float4* al = a.alpha + (long long)b * a.T * fs;
  const float* emb = a.em + (long long)b * a.T * fs;
  float2* gm = a.gam + (long long)b * a.T * fs + k;
  // the start's record, and a dead state's: its weights finite, its adjoints 0
  const float4 init = make_float4(k == 0 ? 0.0f : LOG_EPS, LOG_EPS, LOG_EPS, LOG_EPS);
  // state k's record of frame t (t = -1: the start)
  auto record = [&](int t) -> float4 { return t < 0 || !live ? init : al[t * fs + k]; };

  // the final lae, lae(phi[L], emit[L-1]), in threads L and L - 1 alike
  float g_phi = 0.0f, g_emit = 0.0f;
  if (live) {
    if (k == L && L == 0) g_phi = 1.0f;
    if (L > 0 && (k == L || k == L - 1)) {
      const float p = t_run > 0 ? al[(t_run - 1) * fs + L].x : LOG_EPS;
      const float e = t_run > 0 ? al[(t_run - 1) * fs + L - 1].y : LOG_EPS;
      const float last_lae = lae(p, e);
      if (k == L) g_phi = expf(__fsub_rn(p, last_lae));
      else g_emit = expf(__fsub_rn(e, last_lae));
    }
  }

  // ring slot f: frame t's record and its blank and label emissions
  float4 rr[BWD_RING];
  float rb[BWD_RING], re[BWD_RING];
  auto load = [&](int f, int t) {
    rr[f] = record(t);
    rb[f] = live && t >= 0 ? emb[t * fs + a.N] : 0.0f;
    re[f] = k < L && t >= 0 ? emb[t * fs + k] : 0.0f;
  };
  // frame t's weights from its slot (the states after it, emit[k - 1]
  // before it, its pp and emissions) and the states before it (the slot of
  // frame t - 1)
  auto frame_weights = [&](int f, int before) {
    const float4 cur = rr[f];
    return weights(k, c, rr[before].x, rr[before].y, cur.z, cur.w, re[f], rb[f],
                   make_float2(cur.x, cur.y));
  };
  // after frame t_run - x H: the previous CTA's halo from this CTA's first warp
  auto refresh = [&](int x) {
    const int slot = (x & 1) * H;  // two exchanges in flight at most
    if (w == 0 && prev_halo != nullptr) prev_halo[slot + lane] = make_float2(g_phi, g_emit);
    cluster_arrive();
    cluster_wait();
    if (w == g - 1 && !last) {
      const float2 s = halo[slot + lane];
      g_phi = s.x;
      g_emit = s.y;
    }
  };
#pragma unroll
  for (int f = 0; f < BWD_RING; ++f) load(f, t_run - 1 - f);
  Weights wt = frame_weights(0, 1);

  for (int t0 = t_run - 1; t0 >= 0; t0 -= BWD_RING) {
#pragma unroll
    for (int f = 0; f < BWD_RING; ++f) {
      const int t = t0 - f;
      if (t < 0) break;
      // the chain, with frame t's weights
      const float g_a = __fmul_rn(g_emit, wt.a);
      const float g_pp = __fadd_rn(g_a, __fmul_rn(g_phi, wt.c));
      if (owned) {
        const float lab = k < L ? __fadd_rn(g_a, __fmul_rn(g_emit, wt.b)) : 0.0f;
        const float blk = k == 0 ? g_phi
                                 : __fadd_rn(__fmul_rn(g_phi, wt.c), __fmul_rn(g_phi, wt.d));
        gm[t * fs] = make_float2(lab, blk);
      }
      const float send = __fadd_rn(__fmul_rn(g_phi, wt.d), __fmul_rn(g_pp, wt.l));
      g_phi = __fmul_rn(g_pp, wt.p);
      if (SYNC != WARP && lane == 0 && w > 0) in[(f & 1) * MAX_WARPS + w - 1] = send;
      const float w_b = wt.b;
      // frame t - 1's weights while the others reach the barrier
      wt = frame_weights((f + 1) % BWD_RING, (f + 2) % BWD_RING);
      if (SYNC != WARP) named_sync(BAR, 32 * g);
      float from_right = __shfl_down_sync(FULL, send, 1);
      if (lane == 31) from_right = SYNC != WARP && w + 1 < g ? in[(f & 1) * MAX_WARPS + w] : 0.0f;
      g_emit = __fadd_rn(__fmul_rn(g_emit, w_b), from_right);
      load(f, t - BWD_RING);
      if (SYNC == CLUSTER && t > 0 && (t_run - t) % H == 0) refresh((t_run - t) / H);
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS) ctc_beta_rows(Args a) {
  __shared__ float inbound[2 * MAX_WARPS];
  const int b = blockIdx.x, i = threadIdx.x, w = i >> 5;
  const int L = a.lens[b];
  if (bad_len(a, L)) return;  // the epilogue writes the row's NaN
  const int g = (L + 32) / 32;
  if (w >= g) return;
  const int* tok = a.tokens + (long long)b * a.N;
  const bool bad = bad_label(a, tok, L, i, 32 * g);  // alpha stored nothing: no adjoints
  if (g == 1 ? __any_sync(FULL, bad) : named_any(BAR, 32 * g, bad)) return;
  const int t_run = frames(a, b);
  if (g == 1) {
    run_beta<WARP>(a, b, L, tok, t_run, i, 1, 0, 0, INT_MAX, inbound, nullptr, nullptr, true);
  } else {
    run_beta<GROUP>(a, b, L, tok, t_run, i, g, 0, 0, INT_MAX, inbound, nullptr, nullptr, true);
  }
}

// "cluster": CTA r of cluster b holds the slice [r S, (r + 1) S) of row b's
// states and, on its last warp, the halo after it
__global__ void __launch_bounds__(MAX_THREADS) ctc_beta_cluster(Args a) {
  __shared__ float inbound[2 * MAX_WARPS];
  __shared__ float2 halo[2 * H];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.cluster, rank = (int)cluster.block_rank();
  const int b = blockIdx.x / n, i = threadIdx.x, w = i >> 5;
  const int L = a.lens[b];
  if (bad_len(a, L)) return;
  const int* tok = a.tokens + (long long)b * a.N;
  if (__syncthreads_or(bad_label(a, tok, L, i, blockDim.x))) return;
  const int t_run = frames(a, b);
  const int slice = slice_states(L, n);
  const int g = slice / 32 + 1;  // the slice's warps and the halo's
  float2* prev_halo = rank > 0 ? cluster.map_shared_rank(halo, rank - 1) : nullptr;
  cluster.sync();
  if (w >= g) {
    for (int x = max(t_run - 1, 0) / H; x > 0; --x) {
      cluster_arrive();
      cluster_wait();
    }
    return;
  }
  run_beta<CLUSTER>(a, b, L, tok, t_run, i, g, rank * slice, rank * slice, (rank + 1) * slice,
                    inbound, halo, prev_halo, rank == n - 1);
}

// frame blockIdx.x of row blockIdx.y: d/dx = g * (exp(lp) * sum gamma - gamma)
__global__ void __launch_bounds__(GRAD_THREADS) ctc_gradient(Args a) {
  // [V] the frame's posterior of each class, [N] its label occupations, [N]
  // each label's next position with its token
  extern __shared__ float post[];
  float* lab = post + a.V;
  int* next = reinterpret_cast<int*>(lab + a.N);
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

bool fits(int B, int T, int V, int N, int blank, int warps, int cluster) {
  const bool shape = B >= 0 && B <= 65535 && T >= 0 && V >= 1 && V <= MAX_VOCAB && N >= 0 &&
                     N <= MAX_LABELS && blank >= 0 && blank < V &&
                     (long long)B * T <= INT_MAX - NORM_WARPS;
  if (!shape || warps < 1 || 32 * warps > MAX_THREADS) return false;
  if (cluster == 1) return 32 * warps >= N + 1;
  return cluster >= 2 && cluster <= MAX_CLUSTER && slice_states(N, cluster) <= 32 * (warps - 1);
}

Args make_args(const float* x, long long row_stride, long long t_stride, int B, int T, int V,
               const int* enc_len, const int* tokens, const int* lens, int N, int blank,
               int warps, int cluster) {
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
  a.warps = warps;
  a.cluster = cluster;
  return a;
}

// one launch of a chain: alpha (forward) or beta, a block a row (cluster 1)
// or a cluster of a.cluster CTAs a row through cudaLaunchKernelEx
cudaError_t launch_chain(bool forward, const Args& a, cudaStream_t stream) {
  if (a.cluster == 1) {
    if (forward) ctc_alpha_rows<<<a.B, 32 * a.warps, 0, stream>>>(a);
    else ctc_beta_rows<<<a.B, 32 * a.warps, 0, stream>>>(a);
    return cudaGetLastError();
  }
  if (a.cluster > 8) {
    static const cudaError_t allowed = [] {
      const cudaError_t e = cudaFuncSetAttribute(
          ctc_alpha_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      return e != cudaSuccess ? e
                              : cudaFuncSetAttribute(
                                    ctc_beta_cluster,
                                    cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }();
    if (allowed != cudaSuccess) return allowed;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.B * a.cluster);
  config.blockDim = dim3(32 * a.warps);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = forward ? cudaLaunchKernelEx(&config, ctc_alpha_cluster, a)
                                  : cudaLaunchKernelEx(&config, ctc_beta_cluster, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x [B, T, V] f32 (row b's frame t at x + b * row_stride + t * t_stride,
// classes contiguous); enc_len, tokens [B, N] and lens int32 in device
// memory; the layout (ops/ctc.py loss_plan): `warps` a block and `cluster`
// CTAs a row (1: a block a row, one state pair a thread, 32 warps >= N + 1;
// 2-16: each CTA a slice of the row plus a halo warp); workspaces norm
// [B, T, 2], em [B, T, N + 1], alpha [B, T, N + 1, 4] f32, link [B, max(N,
// 1), 2] int32; loss [B]. Normalizer and links, then the alpha chain.
// Returns cudaErrorInvalidValue for a shape or layout the kernels do not
// take (N past MAX_LABELS, V > 8192, the blank outside V, B > 65535, a
// layout that cannot hold N + 1 state pairs), else the launches' error.
extern "C" int tilawa_ctc_loss_forward(const float* x, long long row_stride, long long t_stride,
                                       int B, int T, int V, const int* enc_len,
                                       const int* tokens, const int* lens, int N, int blank,
                                       int warps, int cluster, float* norm, float* em,
                                       float* alpha, int* link, float* loss, void* stream) {
  if (!fits(B, T, V, N, blank, warps, cluster)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  Args a = make_args(x, row_stride, t_stride, B, T, V, enc_len, tokens, lens, N, blank, warps,
                     cluster);
  a.norm = reinterpret_cast<float2*>(norm);
  a.em = em;
  a.alpha = reinterpret_cast<float4*>(alpha);
  a.link = reinterpret_cast<int2*>(link);
  a.loss = loss;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int frame_blocks = (int)(((long long)B * T + NORM_WARPS - 1) / NORM_WARPS);
  int keys = 1;
  while (keys < N) keys <<= 1;
  ctc_normalize<<<frame_blocks + B, 32 * NORM_WARPS, keys * sizeof(int), s>>>(a, frame_blocks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_chain(true, a, s);
}

// The forward's arguments and layout, then the upstream gradient grad_loss
// [B] f32, the forward's workspaces, gam [B, T, N + 1, 2] f32 and the
// gradient [B, T, V] f32 (contiguous). The adjoint chain on the layout,
// then the epilogue (a frame a block; V + 2 N words of dynamic shared
// memory).
extern "C" int tilawa_ctc_loss_backward(const float* x, long long row_stride,
                                        long long t_stride, int B, int T, int V,
                                        const int* enc_len, const int* tokens, const int* lens,
                                        int N, int blank, int warps, int cluster,
                                        const float* grad_loss, const float* norm,
                                        const float* em, const float* alpha, const int* link,
                                        float* gam, float* grad, void* stream) {
  if (!fits(B, T, V, N, blank, warps, cluster)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaSuccess;
  static const cudaError_t smem = cudaFuncSetAttribute(
      ctc_gradient, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)((MAX_VOCAB + 2 * MAX_LABELS) * sizeof(float)));
  if (smem != cudaSuccess) return (int)smem;
  Args a = make_args(x, row_stride, t_stride, B, T, V, enc_len, tokens, lens, N, blank, warps,
                     cluster);
  a.grad_loss = grad_loss;
  a.norm = reinterpret_cast<float2*>(const_cast<float*>(norm));
  a.em = const_cast<float*>(em);
  a.alpha = reinterpret_cast<float4*>(const_cast<float*>(alpha));
  a.link = reinterpret_cast<int2*>(const_cast<int*>(link));
  a.gam = reinterpret_cast<float2*>(gam);
  a.grad = grad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_chain(false, a, s);
  if (err != cudaSuccess) return (int)err;
  ctc_gradient<<<dim3(T, B), GRAD_THREADS, (V + 2 * N) * sizeof(float), s>>>(a);
  return (int)cudaGetLastError();
}
