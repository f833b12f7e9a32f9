// Log-mel fbank + delta frontend: (B, N) waveforms -> (B, T, D) features in
// one launch.
//
// Replaces attention_lvcsr_tpu/ops/pallas/frontend.py::fbank_deltas_pallas
// (the Pallas kernel of the serving path's waveform requests).  Per frame
// t of utterance b (frame_length samples from t * hop):
//
//   re, im   = frame @ a_cos, frame @ a_sin      (the rFFT as two DFT
//              products; preemphasis and the Hamming window are folded
//              into the tables on the host)
//   mel      = log(max((re^2 + im^2) @ fb, 1e-10))
//   energy   = log(max(sum frame^2, 1e-10))      (the raw frame)
//   base     = [energy | mel]  (energy only with use_energy)
//
// then `order` delta passes of the 5-tap regression filter of window 2
// (Kaldi's add-deltas default; a correlation), with Kaldi's edge replication at each row's true frame
// count n = num_frames[b]: rows at or past n are copies of row n - 1
// before and after every pass, and the time axis is edge-replicated.  In
// index form every pass reads row clamp(s + m - 2, 0, n - 1) of the
// pass before, and output row t is row min(t, n - 1) of each level.
//
// What bounds it on the card: float32 operations, 2 * frame_length *
// n_freqs * 2 FMAs per frame for the DFT products (the mel product and the
// rest are a few per cent).  Design: one block per (utterance, tile of
// `rows` output frames) computes the base features of the tile and of a
// halo of order * 2 frames on each side (64 frames in all), so both
// delta passes run in the same launch, from shared memory; the halo is
// recomputed by the neighbouring tile (8 of 64 frames at the defaults).
// The tile's waveform span ((64 - 1) * hop + frame_length samples) is
// loaded into shared memory once and every frame is read from it: no
// (T, frame_length) gather in device memory.  The DFT tables stream
// through shared memory 16 samples x 64 bins at a time; each thread keeps
// a 4-frame x 4-bin register tile of both products (its four bins
// consecutive, one float4 load per table and sample), accumulated with
// fmaf in sample order; a thread whose frames lie past the tile's needed
// ones (a tile past a row's true end needs at most 2 * halo + 1) skips
// the products.  After each 64-bin chunk the block squares it into a
// power tile and adds the chunk's part of the mel product, in bin order,
// so every sum is taken in a fixed order.
#include <cuda_runtime.h>

constexpr int kWindow = 2;     // delta filter half-width (ops/frontend.py)

// Must match the ctypes.Structure in ops/frontend.py field for field.
struct FrontendArgs {
  const float* wav;        // (B, N)
  const int* num_frames;   // (B,), each in [1, T]
  const float* a_cos;      // (frame_length, n_freqs)
  const float* a_sin;
  const float* fb;         // (n_freqs, num_bins): the mel matrix, transposed
  float* out;              // (B, T, (use_energy + num_bins) * (1 + order))
  int B, N, T, frame_length, hop, n_freqs, num_bins, use_energy, order,
      rows;                // rows: output frames per block
};

namespace {

// delta_coeffs(2) of data/features.py: i / 10 for i in -2..2, as float32
__constant__ float kCoeffs[2 * kWindow + 1] = {-0.2f, -0.1f, 0.f, 0.1f,
                                               0.2f};
constexpr int kFrames = 64;    // frames whose base features a block computes
constexpr int kThreads = 256;  // 16 frame groups x 16 bin groups
constexpr int kBins = 64;      // DFT bins per chunk
constexpr int kSlice = 16;     // samples per staged slice of the tables
constexpr int kPw = kBins + 1; // power tile row stride

struct FrontLayout {
  int wav, tc, ts, pw, lev, total;   // offsets in floats
};

__host__ __device__ inline FrontLayout front_layout(const FrontendArgs& a) {
  const int d0 = a.num_bins + a.use_energy;
  FrontLayout o;
  o.wav = 0;                                   // the tile's waveform span
  o.tc = ((kFrames - 1) * a.hop + a.frame_length + 3) / 4 * 4;
  o.ts = o.tc + kSlice * kBins;                // table slices
  o.pw = o.ts + kSlice * kBins;                // (kFrames, kPw) power
  o.lev = o.pw + kFrames * kPw;                // (1 + order) x (kFrames, d0)
  o.total = o.lev + (1 + a.order) * kFrames * d0;
  return o;
}

__global__ void __launch_bounds__(kThreads)
    frontend_kernel(FrontendArgs a) {
  extern __shared__ __align__(16) float smem[];
  const FrontLayout o = front_layout(a);
  float* wav_s = smem + o.wav;
  float* tc = smem + o.tc;
  float* ts = smem + o.ts;
  float* pw = smem + o.pw;
  float* lev = smem + o.lev;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int T = a.T, FL = a.frame_length, hop = a.hop, nf_bins = a.n_freqs;
  const int d0 = a.num_bins + a.use_energy, moff = a.use_energy;
  const int n = a.num_frames[b];
  const int r0 = blockIdx.x * a.rows, r1 = min(r0 + a.rows, T);
  const int halo = a.order * kWindow;
  // effective rows of the output (min(t, n - 1)) and the base rows they
  // need, all within [0, n - 1]
  const int e_lo = min(r0, n - 1), e_hi = min(r1 - 1, n - 1);
  const int flo = max(e_lo - halo, 0), fhi = min(e_hi + halo, n - 1);
  const int nf = fhi - flo + 1;                // <= kFrames

  // ---- the tile's waveform span (zeros past the end and past the tile)
  const size_t start = (size_t)flo * hop;
  const int span = (nf - 1) * hop + FL;
  const float* wrow = a.wav + (size_t)b * a.N;
  for (int i = tid; i < o.tc; i += kThreads)
    wav_s[i] = i < span && start + i < (size_t)a.N ? wrow[start + i] : 0.f;
  for (int i = tid; i < kFrames * d0; i += kThreads) lev[i] = 0.f;
  __syncthreads();

  // ---- log-energy of the raw frames: one warp per frame, lanes strided
  // over the samples, then a fixed shuffle tree
  if (a.use_energy) {
    const int warp = tid / 32, lane = tid % 32;
    for (int f = warp; f < nf; f += kThreads / 32) {
      float s = 0.f;
      for (int j = lane; j < FL; j += 32) {
        const float x = wav_s[f * hop + j];
        s += x * x;
      }
      for (int off = 16; off > 0; off /= 2)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) lev[f * d0] = logf(fmaxf(s, 1e-10f));
    }
  }

  // ---- DFT products, chunk by chunk of 64 bins; power; mel accumulation
  const int fg = tid / 16, bg = tid % 16;      // frames fg*4+p, bins bg*4+q
  const bool live = fg * 4 < nf;
  for (int chunk0 = 0; chunk0 < nf_bins; chunk0 += kBins) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) re[p][q] = im[p][q] = 0.f;
    for (int k0 = 0; k0 < FL; k0 += kSlice) {
      for (int i = tid; i < kSlice * kBins; i += kThreads) {
        const int k = k0 + i / kBins, bin = chunk0 + i % kBins;
        const bool ok = k < FL && bin < nf_bins;
        tc[i] = ok ? a.a_cos[(size_t)k * nf_bins + bin] : 0.f;
        ts[i] = ok ? a.a_sin[(size_t)k * nf_bins + bin] : 0.f;
      }
      __syncthreads();
      const int kn = live ? min(kSlice, FL - k0) : 0;
      for (int kk = 0; kk < kn; ++kk) {
        float x[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          x[p] = wav_s[(fg * 4 + p) * hop + k0 + kk];
        const float4 c4 =
            *reinterpret_cast<const float4*>(tc + kk * kBins + bg * 4);
        const float4 s4 =
            *reinterpret_cast<const float4*>(ts + kk * kBins + bg * 4);
        const float wc[4] = {c4.x, c4.y, c4.z, c4.w};
        const float ws[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            re[p][q] = fmaf(x[p], wc[q], re[p][q]);
            im[p][q] = fmaf(x[p], ws[q], im[p][q]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pw[(fg * 4 + p) * kPw + bg * 4 + q] =
            re[p][q] * re[p][q] + im[p][q] * im[p][q];
    __syncthreads();
    const int cb_n = min(kBins, nf_bins - chunk0);
    for (int i = tid; i < nf * a.num_bins; i += kThreads) {
      const int f = i / a.num_bins, m = i % a.num_bins;
      float acc = lev[f * d0 + moff + m];
      for (int cb = 0; cb < cb_n; ++cb)
        acc = fmaf(pw[f * kPw + cb],
                   a.fb[(size_t)(chunk0 + cb) * a.num_bins + m], acc);
      lev[f * d0 + moff + m] = acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < nf * a.num_bins; i += kThreads) {
    const int f = i / a.num_bins, m = i % a.num_bins;
    lev[f * d0 + moff + m] = logf(fmaxf(lev[f * d0 + moff + m], 1e-10f));
  }
  __syncthreads();

  // ---- delta passes: level p over rows [lo, hi] from level p - 1
  for (int p = 1; p <= a.order; ++p) {
    const int reach = kWindow * (a.order - p);
    const int lo = max(e_lo - reach, 0), hi = min(e_hi + reach, n - 1);
    const float* src = lev + (p - 1) * kFrames * d0;
    float* dst = lev + p * kFrames * d0;
    for (int i = tid; i < (hi - lo + 1) * d0; i += kThreads) {
      const int s = lo + i / d0, col = i % d0;
      float acc = 0.f;
      bool first = true;
#pragma unroll
      for (int m = 0; m < 2 * kWindow + 1; ++m) {
        const float c = kCoeffs[m];
        if (c == 0.f) continue;
        const int row = min(max(s + m - kWindow, 0), n - 1);
        const float v = c * src[(row - flo) * d0 + col];
        acc = first ? v : acc + v;
        first = false;
      }
      dst[(s - flo) * d0 + col] = acc;
    }
    __syncthreads();
  }

  // ---- output rows: row t is row min(t, n - 1) of every level
  const int width = d0 * (1 + a.order);
  float* orow = a.out + ((size_t)b * T + r0) * width;
  for (int i = tid; i < (r1 - r0) * width; i += kThreads) {
    const int t = r0 + i / width, col = i % width;
    const int e = min(t, n - 1);
    orow[i] = lev[(col / d0) * kFrames * d0 + (e - flo) * d0 + col % d0];
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes: the wrapper compares it
// with the card's opt-in limit before it launches.
extern "C" int frontend_smem_bytes(const FrontendArgs* args) {
  return front_layout(*args).total * (int)sizeof(float);
}

extern "C" int frontend_f32(const FrontendArgs* args, void* stream) {
  const FrontendArgs& a = *args;
  if (a.B < 1 || a.T < 1 || a.rows < 1
      || a.rows + 2 * a.order * kWindow > kFrames)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)front_layout(a).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + a.rows - 1) / a.rows, a.B);
  frontend_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
