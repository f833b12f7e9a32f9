// The phases of one attention decode step, shared by the whole-loop decode
// kernel (beam_loop.cu) and the one-step score kernel (decode_score.cu).
//
// Each function runs on one block for one utterance's K hypothesis rows,
// reads and writes shared-memory buffers laid out row-major (K rows of L
// frames, M match columns, ...), and is called by every thread of the
// block.  Functions that read what another thread wrote end with, or
// separate their passes by, __syncthreads(); the caller separates phases.
// The window phases cover only frames [lb, le) of the prior's window:
// outside it the softmax weight is exactly zero, so the convolution and
// the energies there are never needed.  The products are each kernel's
// own: beam_products.cuh for the whole-loop kernel, decode_score.cu's for
// the score kernel.
#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMq = 8;               // energy columns per lane and pass
constexpr float kInf = 1e9f;         // "no hypothesis" cost
constexpr float kBig = 3e38f;        // taken-candidate marker
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void lex_min(float& bv, int& bi, float ov, int oi) {
  if (ov < bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

// window_around_median: each row's bounds [floor(e - before),
// ceil(e + after)) around its median e, from the first frame whose
// cumulative weight reaches 0.5 ("below" frames precede it).  Two rules
// for e: the module path's argmax of switches gives below - 1, and 0 when
// no frame switches (zero_without_switch, attention.py); the TPU score
// kernel gives max(0, below - 1) (decode_score.py).  A warp per row: a
// prefix sum over lane chunks, then a count.
__device__ void median_bounds(const float* W, int K, int L, float before,
                              float after, bool zero_without_switch,
                              float* BEGINS, float* ENDS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < K; r += nwarps) {
    const float* wr = W + r * L;
    const int chunk = (L + 31) / 32;
    const int l0 = min(L, lane * chunk), l1 = min(L, l0 + chunk);
    float part = 0.f;
    for (int l = l0; l < l1; ++l) part += wr[l];
    float incl = part;   // inclusive scan of the lane partial sums
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    float cs = incl - part;
    int below = 0;
    for (int l = l0; l < l1; ++l) {
      cs += wr[l];
      below += cs < 0.5f ? 1 : 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      below += __shfl_xor_sync(0xffffffffu, below, off);
    if (lane == 0) {
      float expected;
      if (zero_without_switch)
        expected = (below >= 1 && below <= L - 1) ? (float)(below - 1) : 0.f;
      else
        expected = fmaxf(0.f, (float)below - 1.f);
      BEGINS[r] = floorf(expected - before);
      ENDS[r] = ceilf(expected + after);
    }
  }
  __syncthreads();
}

// window_around_mean: each row's bounds [floor(e - before), ceil(e +
// after)) around its mean position e = sum_l w[l] * l.  A warp per row:
// lane partial sums, then a butterfly sum.
__device__ void mean_bounds(const float* W, int K, int L, float before,
                            float after, float* BEGINS, float* ENDS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < K; r += nwarps) {
    const float* wr = W + r * L;
    float part = 0.f;
    for (int l = lane; l < L; l += 32) part += wr[l] * (float)l;
    const float expected = warp_sum(part);
    if (lane == 0) {
      BEGINS[r] = floorf(expected - before);
      ENDS[r] = ceilf(expected + after);
    }
  }
  __syncthreads();
}

// The window of the utterance: the union of its rows' bounds, clipped to
// [0, L).  Every thread gets the same [lb, le).
__device__ __forceinline__ void union_window(const float* BEGINS,
                                             const float* ENDS, int K, int L,
                                             int& lb, int& le) {
  float bmin = kBig, emax = -kBig;
  for (int k = 0; k < K; ++k) {
    bmin = fminf(bmin, BEGINS[k]);
    emax = fmaxf(emax, ENDS[k]);
  }
  const float gb = floorf(fmaxf(0.f, bmin));
  const float ge = ceilf(fminf((float)L, emax));
  lb = max(0, (int)gb);
  le = max(lb, min(L, (int)ge));
}

// The expanding prior's window at decode step `step`.
__device__ __forceinline__ void expanding_window(
    int step, int L, float initial_begin, float initial_end, float min_speed,
    float max_speed, int& lb, int& le) {
  const float step0 = (float)step;
  const float gb = floorf(fmaxf(0.f, fminf((float)(L - 1),
                                           initial_begin + step0 * min_speed)));
  const float ge = ceilf(fmaxf(0.f, fminf((float)L,
                                          initial_end + step0 * max_speed)));
  lb = max(0, (int)gb);
  le = max(lb, min(L, (int)ge));
}

// The alignment convolution over the windowed previous weights (a true
// convolution, trimmed 'full' mode), for frames in the window:
// conv[r, l] = sum_j w[r, j] * taps[n + l - j] over j in [lb, le).
__device__ void window_conv(const float* W, const float* TAPS, int n_taps,
                            int K, int L, int lb, int le, float* CONV) {
  const int conv_n = (n_taps - 1) / 2;
  for (int idx = threadIdx.x; idx < K * (le - lb); idx += blockDim.x) {
    const int r = idx / (le - lb), l = lb + idx % (le - lb);
    const int j0 = max(lb, l - conv_n), j1 = min(le - 1, l + conv_n);
    float acc = 0.f;
    for (int j = j0; j <= j1; ++j)
      acc = fmaf(W[r * L + j], TAPS[conv_n + l - j], acc);
    CONV[r * L + l] = acc;
  }
}

// e[r, l] = v . tanh(pre[l] + sp[r] + conv[r, l] * handler) inside the
// window; without kConv (content-only attention) v . tanh(pre[l] + sp[r]),
// CONV and HAND unread.  A warp per frame: a lane keeps its columns of the
// frame's keys, handler and energy vector in registers across the K rows.
template <bool kConv>
__device__ void window_energies(const float* __restrict__ pre, int M,
                                const float* CONV, const float* SP,
                                const float* HAND, const float* VV, int K,
                                int L, int lb, int le, float* E) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int l = lb + warp; l < le; l += nwarps) {
    const float* pl = pre + (size_t)l * M;
    for (int m0 = 0; m0 < M; m0 += 32 * kMq) {
      float pv[kMq], hv[kMq], vv[kMq];
#pragma unroll
      for (int q = 0; q < kMq; ++q) {
        const int m = m0 + lane + 32 * q;
        pv[q] = m < M ? __ldg(pl + m) : 0.f;
        hv[q] = kConv && m < M ? HAND[m] : 0.f;
        vv[q] = m < M ? VV[m] : 0.f;
      }
      for (int r = 0; r < K; ++r) {
        const float c = kConv ? CONV[r * L + l] : 0.f;
        const float* sp = SP + r * M;
        float part = 0.f;
#pragma unroll
        for (int q = 0; q < kMq; ++q) {
          const int m = m0 + lane + 32 * q;
          if (m < M)
            part = fmaf(vv[q],
                        tanhf(kConv ? (pv[q] + sp[m]) + c * hv[q]
                                    : pv[q] + sp[m]),
                        part);
        }
        part = warp_sum(part);
        if (lane == 0) E[r * L + l] = m0 == 0 ? part : E[r * L + l] + part;
      }
    }
  }
}

// The convolutions of nf filters (taps filter after filter) over the
// windowed previous weights, for frames in the window: conv[r, f, l] =
// sum_j w[r, j] * taps[f, n + l - j] over j in [lb, le), CONV rows (r, f)
// of pitch L.  window_conv's arithmetic, filter by filter.
__device__ void window_conv_filters(const float* W, const float* TAPS,
                                    int n_taps, int nf, int K, int L, int lb,
                                    int le, float* CONV) {
  const int conv_n = (n_taps - 1) / 2, width = le - lb;
  for (int idx = threadIdx.x; idx < K * nf * width; idx += blockDim.x) {
    const int rf = idx / width, l = lb + idx % width;
    const float* wr = W + (rf / nf) * L;
    const float* taps = TAPS + (rf % nf) * n_taps;
    const int j0 = max(lb, l - conv_n), j1 = min(le - 1, l + conv_n);
    float acc = 0.f;
    for (int j = j0; j <= j1; ++j)
      acc = fmaf(wr[j], taps[conv_n + l - j], acc);
    CONV[rf * L + l] = acc;
  }
}

// e[r, l] = v . tanh(pre[l] + sp[r] + sum_f conv[r, f, l] * hand[f]) inside
// the window, the handler term summed in filter order (CONV as
// window_conv_filters writes it, HAND nf rows of pitch M).  A warp per
// frame, as window_energies; the handler rows are read from shared memory.
__device__ void window_energies_filters(const float* __restrict__ pre, int M,
                                        const float* CONV, const float* SP,
                                        const float* HAND, const float* VV,
                                        int nf, int K, int L, int lb, int le,
                                        float* E) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int l = lb + warp; l < le; l += nwarps) {
    const float* pl = pre + (size_t)l * M;
    for (int m0 = 0; m0 < M; m0 += 32 * kMq) {
      float pv[kMq], vv[kMq];
#pragma unroll
      for (int q = 0; q < kMq; ++q) {
        const int m = m0 + lane + 32 * q;
        pv[q] = m < M ? __ldg(pl + m) : 0.f;
        vv[q] = m < M ? VV[m] : 0.f;
      }
      for (int r = 0; r < K; ++r) {
        const float* cr = CONV + (size_t)r * nf * L + l;
        const float* sp = SP + r * M;
        float part = 0.f;
#pragma unroll
        for (int q = 0; q < kMq; ++q) {
          const int m = m0 + lane + 32 * q;
          if (m < M) {
            float term = cr[0] * HAND[m];
            for (int f = 1; f < nf; ++f)
              term = term + cr[f * L] * HAND[f * M + m];
            part = fmaf(vv[q], tanhf((pv[q] + sp[m]) + term), part);
          }
        }
        part = warp_sum(part);
        if (lane == 0) E[r * L + l] = m0 == 0 ? part : E[r * L + l] + part;
      }
    }
  }
}

// Masked normalization of each row's energies, in place, into its new
// weights.  kNorm 0 (softmax): the stabilising max runs over the window
// only, and the weight of frame l is exp(e - max) * combined[l], with
// combined = window * mask, times the row's own bounds (strict) under the
// median prior.  kNorm 1 (logistic) and 2 (relu): sigmoid(e + ebias) and
// max((e + ebias) / 1000, 0) times combined[l].  A row whose combined
// mask is all zero gets zero weights; under relu a row whose numerators
// are all zero over a non-empty mask gets zero weights too, and BAD[r] = 1
// (else 0).  A warp per row.
template <int kNorm = 0>
__device__ void window_softmax(float* E, const float* MASK,
                               const float* BEGINS, const float* ENDS,
                               bool prior_median, int K, int L, int lb,
                               int le, float ebias = 0.f,
                               float* BAD = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < K; r += nwarps) {
    float* er = E + r * L;
    float mx = 0.f;
    if (kNorm == 0) {
      mx = kNeg;
      for (int l = lb + lane; l < le; l += 32) mx = fmaxf(mx, er[l]);
      mx = warp_max(mx);
      if (!(mx > kNeg / 2)) mx = 0.f;
    }
    float sum = 0.f, csum = 0.f;
    for (int l = lane; l < L; l += 32) {
      float comb = 0.f;
      if (l >= lb && l < le) {
        comb = MASK[l];
        if (prior_median)
          comb = comb * (((float)l > BEGINS[r] && (float)l < ENDS[r])
                             ? 1.f : 0.f);
      }
      float un = 0.f;
      if (comb != 0.f) {
        if (kNorm == 0) {
          un = expf(er[l] - mx) * comb;
        } else {
          const float e = er[l] + ebias;
          const float g = kNorm == 1 ? 1.f / (1.f + expf(-e))
                                     : fmaxf(e / 1000.f, 0.f);
          un = g * comb;
        }
      }
      er[l] = un;
      sum += un;
      csum += comb;
    }
    sum = warp_sum(sum);
    csum = warp_sum(csum);
    float denom = sum + (csum == 0.f ? 1.f : 0.f);
    if (kNorm == 2) {
      if (lane == 0) BAD[r] = denom == 0.f ? 1.f : 0.f;
      denom += denom == 0.f ? 1.f : 0.f;
    }
    for (int l = lane; l < L; l += 32) er[l] = er[l] / denom;
  }
}

// act = tanh(act), in place over n values.
__device__ void tanh_in_place(float* ACT, int n) {
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
    ACT[idx] = tanhf(ACT[idx]);
}

// The readout's post-merge activation of K rows of R merged units
// (post_act 0 tanh, 1 relu, 2 sigmoid, 3 identity: in place; 4 maxout: the
// max of each group of `pieces` consecutive units of a row into OUT, K
// rows of R / pieces).  Returns the rows the post-merge product reads.
__device__ float* post_merge_act(float* ACT, int K, int R, int post_act,
                                 int pieces, float* OUT) {
  if (post_act == 4) {
    const int Rm = R / pieces;
    for (int idx = threadIdx.x; idx < K * Rm; idx += blockDim.x) {
      const float* g = ACT + (idx / Rm) * R + (idx % Rm) * pieces;
      float mx = g[0];
      for (int p = 1; p < pieces; ++p) mx = fmaxf(mx, g[p]);
      OUT[idx] = mx;
    }
    return OUT;
  }
  for (int idx = threadIdx.x; idx < K * R; idx += blockDim.x) {
    const float x = ACT[idx];
    ACT[idx] = post_act == 0   ? tanhf(x)
               : post_act == 1 ? fmaxf(x, 0.f)
               : post_act == 2 ? 1.f / (1.f + expf(-x))
                               : x;
  }
  return ACT;
}

// Logits (K x V) into costs, in place: costs[r, c] = alive[r] + (lse_r -
// logit) (no alive term when `alive` is null).  A warp per row.
__device__ void log_softmax_costs(float* COSTS, int K, int V,
                                  const float* alive) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < K; r += nwarps) {
    float* cr = COSTS + r * V;
    float mx = -__int_as_float(0x7f800000);
    for (int c = lane; c < V; c += 32) mx = fmaxf(mx, cr[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < V; c += 32) sum += expf(cr[c] - mx);
    sum = warp_sum(sum);
    const float lse = mx + logf(sum);
    if (alive != nullptr) {
      const float a = alive[r];
      for (int c = lane; c < V; c += 32) cr[c] = a + (lse - cr[c]);
    } else {
      for (int c = lane; c < V; c += 32) cr[c] = lse - cr[c];
    }
  }
}

}  // namespace
