// Log-mel fbank + delta frontend: (B, N) waveforms -> (B, T, D) features in
// one launch.
//
// Replaces attention_lvcsr_tpu/ops/pallas/frontend.py::fbank_deltas_pallas
// (the Pallas kernel of the serving path's waveform requests).  Per frame
// t of utterance b (frame_length samples from t * hop):
//
//   x'[s]    = win[s] (x[s] - 0.97 x[s-1]), x[-1] := x[0]; zero past the
//              frame, up to n = fft_size samples
//   X        = the real FFT of x' (n / 2 + 1 bins)
//   mel      = log(max(sum over each filter's bins of |X[k]|^2 w[k], 1e-10))
//   energy   = log(max(sum frame^2, 1e-10))      (the raw frame)
//   base     = [energy | mel]  (energy only with use_energy)
//
// then `order` delta passes of the 5-tap regression filter of window 2
// (Kaldi's add-deltas default; a correlation), with Kaldi's edge
// replication at each row's true frame count n_b = num_frames[b]: rows at
// or past n_b are copies of row n_b - 1 before and after every pass, and
// the time axis is edge-replicated.  In index form every pass reads row
// clamp(s + m - 2, 0, n_b - 1) of the pass before, and output row t is row
// min(t, n_b - 1) of each level.
//
// What bounds it on the card: the bytes (the waveforms in, the features
// out); a frame's FFT, power and mel sums are ~18k float32 operations at
// 16 kHz, where the TPU kernel's DFT products were 411k (the MXU absorbs
// them, the H100's float32 units do not).  Design: one block per
// (utterance, tile of `rows` output frames) computes the base features of
// the tile and of a halo of order * 2 frames on each side, so both delta
// passes run in the same launch, from shared memory; ops/frontend.py::plan
// picks the tile so that a single request gives a block per SM.  The
// tile's waveform span and the tables (window, twiddles, the mel
// schedule; float64 rounded to float32 on the host) are copied into shared
// memory with cp.async.  A warp computes one frame at a time: its n / 2 =
// 32 P point complex FFT (z[m] = x'[2m] + i x'[2m+1]) holds P points a
// lane, z[lane + 32 j]; a P-point DIF FFT in registers, the twiddle
// W_N^(lane p), five cross-lane DIF stages by shuffles, then the real
// split, whose partner bin N - k lies in lane 31 - lane (lane br5(32 -
// br5(lane)) for register 0).  Lane l then holds the power of the P
// consecutive bins [q P, q P + P), q = br5(l), in registers; it sums them
// into the filters they lie in with two running sums (a bin lies in at
// most two neighbouring filters) and emits each partial sum to a slot, and
// each filter adds its slots (ops/frontend.py::mel_schedule).  Every sum
// has a fixed order and there are no atomics, so a second call repeats its
// bits.
#include <cuda_runtime.h>

#include <utility>

#include "dynamic_smem.cuh"
#include "sm90_async.cuh"

constexpr int kWindow = 2;     // delta filter half-width (ops/frontend.py)

// Must match the ctypes.Structure in ops/frontend.py field for field.
struct FrontendArgs {
  const float* wav;        // (B, N)
  const int* num_frames;   // (B,), each in [1, T]
  const float* tables;     // ops/frontend.py::host_tables: window,
                           // twiddles, then the mel weights
  const int* ints;         // the mel schedule: steps, slots, slot offsets
  float* out;              // (B, T, (use_energy + num_bins) * (1 + order))
  int B, N, T, frame_length, hop, log2n, num_bins,
      mel_emits,           // emits a lane makes at most (ops/frontend.py::
      mel_slots,           // mel_schedule) and partial sums a frame
      use_energy, order,
      rows;                // rows: output frames per block
  float preemphasis;
};

namespace {

// delta_coeffs(2) of data/features.py, tap m: (m - 2) / 10 as float32
__host__ __device__ constexpr float delta_coeff(int m) {
  return (m - kWindow) * 0.1f;
}
constexpr int kWarps = 8;      // a warp computes one frame at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxFrames = 48; // frames whose base features a block computes

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Offsets in floats of the tables' parts (n = 64 P); complex values are
// (re, im) pairs.
struct TableOffsets {
  int win, twp, twl, tws, twk, melw, total;
};

__host__ __device__ inline TableOffsets table_offsets(int P) {
  TableOffsets t;
  t.win = 0;                   // n: the window, zero past the frame
  t.twp = 64 * P;              // P / 2 complex: W_P^k
  t.twl = t.twp + P;           // [i][lane]: W_N^(lane * br_P(i))
  t.tws = t.twl + 64 * P;      // [stage][lane]: the cross-lane twiddles
  t.twk = t.tws + 4 * 64;      // [i][lane]: W_n^k of register i's bin
  t.melw = t.twk + 64 * P;     // [r][lane]: bin r's weights in f, f + 1
  t.total = t.melw + 64 * (P + 1);
  return t;
}

// Offsets of the mel schedule's parts in the integer table.
struct IntOffsets {
  int adv, slot, segoff, total;
};

__host__ __device__ inline IntOffsets int_offsets(const FrontendArgs& a) {
  const int P = (1 << a.log2n) / 64;
  IntOffsets t;
  t.adv = 0;                           // [r][lane]: the step of f at bin r
  t.slot = 32 * (P + 1);               // [e][lane]: emit e's slot
  t.segoff = t.slot + 32 * a.mel_emits;  // filter m's slots
  t.total = t.segoff + a.num_bins + 1;
  return t;
}

struct FrontLayout {
  int tables, ints, wav, part, lev, total;   // offsets in floats
};

__host__ __device__ inline FrontLayout front_layout(const FrontendArgs& a) {
  const int P = (1 << a.log2n) / 64;
  const int frames = a.rows + 2 * a.order * kWindow;
  const int d0 = a.num_bins + a.use_energy;
  FrontLayout o;
  o.tables = 0;
  o.ints = round4(table_offsets(P).total);
  o.wav = o.ints + round4(int_offsets(a).total);  // the tile's waveform
  o.part = o.wav + round4((frames - 1) * a.hop + a.frame_length);
  o.lev = o.part + round4(kWarps * (a.mel_slots + 1));  // partial mel sums
  o.total = o.lev + (1 + a.order) * frames * d0;  // (1 + order) levels
  return o;
}

__host__ __device__ constexpr int bitrev(int x, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((x >> b) & 1) << (bits - 1 - b);
  return r;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -(a.y * b.y)), fmaf(a.x, b.y, a.y * b.x));
}

// f(std::integral_constant<int, i>{}) for i = 0 .. n - 1: the index is a
// constant wherever f uses it, so register arrays stay in registers.
template <class F, int... I>
__device__ __forceinline__ void static_for_each(
    F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

template <int n, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_each(f, std::make_integer_sequence<int, n>{});
}

// The power spectrum of the frame at x (frame_length samples in shared
// memory): bin k = br_P(i) + P br5(lane) < N in register pwr[i] of the
// lane, the Nyquist bin N in nyq of lane 0.  Returns the lane's share of
// the raw frame's energy: its samples' squares, in order.
template <int LOGP>
__device__ __forceinline__ float frame_power(const float* x, int fl,
                                            float pre, const float* win,
                                            const float2* twp,
                                            const float2* twl,
                                            const float2 (&tws)[4],
                                            const float2* twk,
                                            float (&pwr)[1 << LOGP],
                                            float& nyq, int lane) {
  constexpr int P = 1 << LOGP;
  float2 v[P];
  float energy = 0.f;
  // ---- z[lane + 32 j]: preemphasis and window as the samples are read
  static_for<P>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    const int s = 2 * (lane + 32 * j);
    const float x0 = s < fl ? x[s] : 0.f;
    const float x1 = s + 1 < fl ? x[s + 1] : 0.f;
    const float xm = s == 0 ? x0 : (s - 1 < fl ? x[s - 1] : 0.f);
    v[j] = make_float2(win[s] * (x0 - pre * xm),
                       win[s + 1] * (x1 - pre * x0));
    energy = fmaf(x1, x1, fmaf(x0, x0, energy));
  });
  // ---- the lane's P-point DIF FFT: register i then holds bin br_P(i)
  static_for<LOGP>([&](auto stc) {
    constexpr int st = decltype(stc)::value, half = (P >> st) / 2;
    static_for<P / 2>([&](auto bfc) {      // butterfly (a, a + half)
      constexpr int bf = decltype(bfc)::value;
      constexpr int k = bf % half, a = (bf / half) * 2 * half + k;
      const float2 u = v[a], w = v[a + half];
      v[a] = make_float2(u.x + w.x, u.y + w.y);
      const float2 d = make_float2(u.x - w.x, u.y - w.y);
      v[a + half] = k == 0 ? d : cmul(d, twp[k << st]);
    });
  });
  static_for<P - 1>([&](auto ic) {
    constexpr int i = decltype(ic)::value + 1;
    v[i] = cmul(v[i], twl[i * 32 + lane]);
  });
  // ---- the cross-lane DIF stages: lane then holds q = br5(lane)
  static_for<5>([&](auto stc) {
    constexpr int st = decltype(stc)::value, h = 16 >> st;
    const float sg = (lane & h) ? -1.f : 1.f;
    static_for<P>([&](auto ic) {
      constexpr int i = decltype(ic)::value;
      const float ux = __shfl_xor_sync(0xffffffffu, v[i].x, h);
      const float uy = __shfl_xor_sync(0xffffffffu, v[i].y, h);
      const float2 y = make_float2(fmaf(sg, v[i].x, ux), fmaf(sg, v[i].y, uy));
      if constexpr (st < 4) {
        v[i] = cmul(y, tws[st]);
      } else {
        v[i] = y;                              // h = 1: W_2^0
      }
    });
  });
  // ---- the real split: X[k] = (S - i W_n^k D) / 2 with S, D = Z[k] +-
  // conj(Z[N - k]); Z[N - k] of register i' = br_P(P - br_P(i)) in lane
  // 31 - lane (i > 0), or of register 0 in lane br5(32 - br5(lane))
  const int q = __brev(lane) >> 27;
  const int src0 = lane == 0 ? 0 : (int)(__brev((32 - q) & 31) >> 27);
  static_for<P>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    constexpr int ip = i == 0 ? 0 : bitrev(P - bitrev(i, LOGP), LOGP);
    const int src = i == 0 ? src0 : 31 - lane;
    const float bx = __shfl_sync(0xffffffffu, v[ip].x, src);
    const float by = __shfl_sync(0xffffffffu, v[ip].y, src);
    const float sr = v[i].x + bx, si = v[i].y - by;
    const float dr = v[i].x - bx, di = v[i].y + by;
    const float2 w = twk[i * 32 + lane];
    const float xr = 0.5f * (sr + (w.x * di + w.y * dr));
    const float xi = 0.5f * (si - (w.x * dr - w.y * di));
    pwr[i] = xr * xr + xi * xi;
  });
  const float z = v[0].x - v[0].y;     // X[N] where lane == 0
  nyq = z * z;
  return energy;
}

// The lane's partial mel sums (ops/frontend.py::mel_schedule): its bins
// [q P, q P + P) in order (and lane 31 the Nyquist bin as bin P), two
// running sums A (filter f) and B (f + 1); where f steps up, A goes to the
// lane's next slot, B becomes A and a zero B starts.  Slots of filters
// outside [0, num_bins) land in part[slots], never read.
template <int LOGP>
__device__ __forceinline__ void mel_partials(const float (&pwr)[1 << LOGP],
                                             float nyq, const int* adv,
                                             const int* slot,
                                             const float2* melw, float* part,
                                             int lane) {
  constexpr int P = 1 << LOGP;
  const float pn = __shfl_sync(0xffffffffu, nyq, 0);
  float A = 0.f, B = 0.f;
  const int* next = slot + lane;
  static_for<P + 1>([&](auto rc) {
    constexpr int r = decltype(rc)::value;
    float p;
    if constexpr (r < P) {
      p = pwr[bitrev(r, LOGP)];
    } else {
      p = pn;
    }
    for (int d = adv[r * 32 + lane]; d > 0; --d) {
      part[*next] = A;
      next += 32;
      A = B;
      B = 0.f;
    }
    const float2 w = melw[r * 32 + lane];
    A = fmaf(p, w.x, A);
    B = fmaf(p, w.y, B);
  });
  part[next[0]] = A;
  part[next[32]] = B;
}

template <int LOGP>
__global__ void __launch_bounds__(kThreads)
    frontend_kernel(FrontendArgs a) {
  constexpr int P = 1 << LOGP;
  extern __shared__ __align__(16) float smem[];
  const FrontLayout o = front_layout(a);
  const TableOffsets to = table_offsets(P);
  const IntOffsets io = int_offsets(a);
  float* tab = smem + o.tables;
  int* ints = reinterpret_cast<int*>(smem + o.ints);
  float* wav_s = smem + o.wav;
  float* lev = smem + o.lev;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int T = a.T, FL = a.frame_length, hop = a.hop, nb = a.num_bins;
  const int d0 = nb + a.use_energy, moff = a.use_energy;
  const int frames = a.rows + 2 * a.order * kWindow;
  const int n = a.num_frames[b];
  const int r0 = blockIdx.x * a.rows, r1 = min(r0 + a.rows, T);
  const int halo = a.order * kWindow;
  // effective rows of the output (min(t, n - 1)) and the base rows they
  // need, all within [0, n - 1]
  const int e_lo = min(r0, n - 1), e_hi = min(r1 - 1, n - 1);
  const int flo = max(e_lo - halo, 0), fhi = min(e_hi + halo, n - 1);
  const int nf = fhi - flo + 1;                // <= frames

  // ---- copies: the tables, the mel schedule, the tile's waveform span
  // (zeros past the end of the row)
  for (int i = 4 * tid; i < to.total; i += 4 * kThreads)
    cp_async<16>(tab + i, a.tables + i, 4 * min(4, to.total - i));
  for (int i = 4 * tid; i < io.total; i += 4 * kThreads)
    cp_async<16>(reinterpret_cast<float*>(ints + i),
                 reinterpret_cast<const float*>(a.ints + i),
                 4 * min(4, io.total - i));
  const size_t start = (size_t)flo * hop;
  const int span = (nf - 1) * hop + FL;
  const float* wrow = a.wav + (size_t)b * a.N;
  for (int i = tid; i < span; i += kThreads) {
    const bool in = start + i < (size_t)a.N;
    cp_async<4>(wav_s + i, in ? wrow + start + i : wrow, in ? 4 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- base features, one frame a warp at a time
  const float* win = tab + to.win;
  const float2* twp = reinterpret_cast<const float2*>(tab + to.twp);
  const float2* twl = reinterpret_cast<const float2*>(tab + to.twl);
  const float2* twk = reinterpret_cast<const float2*>(tab + to.twk);
  const float2* melw = reinterpret_cast<const float2*>(tab + to.melw);
  const int* segoff = ints + io.segoff;
  float2 tws[4];
#pragma unroll
  for (int st = 0; st < 4; ++st)
    tws[st] = reinterpret_cast<const float2*>(tab + to.tws)[st * 32 + lane];
  float* part = smem + o.part + warp * (a.mel_slots + 1);
  for (int f = warp; f < nf; f += kWarps) {
    // ---- the frame's FFT and power spectrum
    const float* x = wav_s + f * hop;
    float pwr[P], nyq;
    float s = frame_power<LOGP>(x, FL, a.preemphasis, win, twp, twl, tws,
                                twk, pwr, nyq, lane);
    // ---- energy: the lanes' shares in a fixed tree
    if (a.use_energy) {
      for (int off = 16; off > 0; off /= 2)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) lev[f * d0] = logf(fmaxf(s, 1e-10f));
    }
    // ---- mel sums: the lanes' partial sums over their own bins
    mel_partials<LOGP>(pwr, nyq, ints + io.adv, ints + io.slot, melw, part,
                       lane);
    __syncwarp();
    // ---- a filter the sum of its slots, in order, and the log
    for (int m = lane; m < nb; m += 32) {
      float acc = 0.f;
      for (int g = segoff[m]; g < segoff[m + 1]; ++g) acc += part[g];
      lev[f * d0 + moff + m] = logf(fmaxf(acc, 1e-10f));
    }
    __syncwarp();                  // the slots are the next frame's
  }
  __syncthreads();

  // ---- delta passes: level p over rows [lo, hi] from level p - 1, a warp
  // a row
  for (int p = 1; p <= a.order; ++p) {
    const int reach = kWindow * (a.order - p);
    const int lo = max(e_lo - reach, 0), hi = min(e_hi + reach, n - 1);
    const float* src = lev + (p - 1) * frames * d0;
    float* dst = lev + p * frames * d0;
    for (int s = lo + warp; s <= hi; s += kWarps)
      for (int col = lane; col < d0; col += 32) {
        float acc = 0.f;
        static_for<2 * kWindow + 1>([&](auto mc) {
          constexpr int m = decltype(mc)::value;
          constexpr float c = delta_coeff(m);
          if constexpr (c != 0.f) {
            const int row = min(max(s + m - kWindow, 0), n - 1);
            const float v = c * src[(row - flo) * d0 + col];
            acc = m == 0 ? v : acc + v;
          }
        });
        dst[(s - flo) * d0 + col] = acc;
      }
    __syncthreads();
  }

  // ---- output rows: row t is row min(t, n - 1) of every level
  const int width = d0 * (1 + a.order);
  for (int t = r0 + warp; t < r1; t += kWarps) {
    const float* erow = lev + (min(t, n - 1) - flo) * d0;
    float* orow = a.out + ((size_t)b * T + t) * width;
    for (int col = lane; col < width; col += 32) {
      int p = 0, c = col;            // level p, column c of it
      for (; c >= d0; c -= d0) ++p;
      orow[col] = erow[p * frames * d0 + c];
    }
  }
}
template <int LOGP>
cudaError_t launch(const FrontendArgs& a, cudaStream_t stream) {
  static SmemAllowance allowed;    // this instance's, per device
  const int smem = front_layout(a).total * (int)sizeof(float);
  const cudaError_t err =
      allow_dynamic_smem(frontend_kernel<LOGP>, allowed, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + a.rows - 1) / a.rows, a.B);
  frontend_kernel<LOGP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes (ops/frontend.py::layout
// mirrors it).
extern "C" int frontend_smem_bytes(const FrontendArgs* args) {
  return front_layout(*args).total * (int)sizeof(float);
}

extern "C" int frontend_f32(const FrontendArgs* args, void* stream) {
  const FrontendArgs& a = *args;
  if (a.B < 1 || a.T < 1 || a.rows < 1 || a.num_bins < 1
      || a.frame_length > (1 << a.log2n)
      || a.rows + 2 * a.order * kWindow > kMaxFrames)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (a.log2n) {
    case 8: return (int)launch<2>(a, s);      // 8 kHz
    case 9: return (int)launch<3>(a, s);      // 16 kHz
    case 10: return (int)launch<4>(a, s);     // 22.05 kHz
    case 11: return (int)launch<5>(a, s);     // 44.1, 48 kHz
    default: return (int)cudaErrorInvalidValue;
  }
}
