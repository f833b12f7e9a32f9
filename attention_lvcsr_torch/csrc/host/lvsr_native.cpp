// Native host kernels of the PyTorch port: the batched edit-distance,
// reward and gain DP of the task loss, and batched edit distances.
//
// The port's copy of the JAX package's native/lvsr_native.cpp, built at
// first use by attention_lvcsr_torch/ops/native.py:
//
//   g++ -O3 -fPIC -shared -std=c++17 -o liblvsr_native.so lvsr_native.cpp
//
// into build/host/<hash>/ at the repository root and bound with ctypes.
// Semantics match attention_lvcsr_torch/ops/error_rate.py exactly; the
// numpy rows there are the fallback where no compiler exists.  This is
// host code, not a device kernel.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kInf = int64_t{1} << 40;

// Full Levenshtein DP matrix between y (length n) and y_hat (length m).
// dist is (n+1) x (m+1), row-major.
void edit_distance_matrix(const int64_t* y, int64_t n, const int64_t* y_hat,
                          int64_t m, std::vector<int64_t>& dist) {
  dist.assign((n + 1) * (m + 1), 0);
  auto D = [&](int64_t i, int64_t j) -> int64_t& {
    return dist[i * (m + 1) + j];
  };
  for (int64_t i = 0; i <= n; ++i) D(i, 0) = i;
  for (int64_t j = 0; j <= m; ++j) D(0, j) = j;
  for (int64_t i = 1; i <= n; ++i) {
    const int64_t yc = y[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t diag = D(i - 1, j - 1) + (yc != y_hat[j - 1] ? 1 : 0);
      const int64_t ins = D(i - 1, j) + 1;
      const int64_t del = D(i, j - 1) + 1;
      D(i, j) = std::min(diag, std::min(ins, del));
    }
  }
}

// reward_matrix semantics (error_rate.py): rewards (m+1, A).
void reward_matrix(const int64_t* y, int64_t n, const int64_t* y_hat,
                   int64_t m, int64_t A, int64_t eos,
                   std::vector<int64_t>& reward) {
  std::vector<int64_t> dist;
  edit_distance_matrix(y, n, y_hat, m, dist);
  auto D = [&](int64_t i, int64_t j) {
    return dist[i * (m + 1) + j];
  };
  std::vector<int64_t> char_dist((m + 1) * A);
  for (int64_t j = 0; j <= m; ++j) {
    int64_t optim = kInf;
    for (int64_t i = 0; i <= n; ++i) optim = std::min(optim, D(i, j));
    for (int64_t c = 0; c < A; ++c) char_dist[j * A + c] = optim + 1;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t c = y[i];
    for (int64_t j = 0; j <= m; ++j) {
      int64_t& cd = char_dist[j * A + c];
      cd = std::min(cd, D(i, j));
    }
  }
  reward.assign((m + 1) * A, 0);
  for (int64_t j = 0; j <= m; ++j)
    for (int64_t c = 0; c < A; ++c)
      reward[j * A + c] = -char_dist[j * A + c];
  for (int64_t j = 0; j <= m; ++j)
    reward[j * A + eos] = -D(n - 1, j);
}

}  // namespace

extern "C" {

// Batched edit distances between padded sequence arrays.
// a: (n, max_a), b: (n, max_b), lengths per row; out: (n,)
void lvsr_edit_distances(const int64_t* a, const int64_t* a_lens,
                         const int64_t* b, const int64_t* b_lens,
                         int64_t n, int64_t max_a, int64_t max_b,
                         int64_t* out) {
  std::vector<int64_t> dist;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t la = a_lens[k], lb = b_lens[k];
    edit_distance_matrix(a + k * max_a, la, b + k * max_b, lb, dist);
    out[k] = dist[la * (lb + 1) + lb];
  }
}

// Batched reward/gain matrices, reference RewardOp semantics
// (lvsr/ops.py:244-285): groundtruth/recognized are (T_g, B)/(T_r, B)
// time-major int64; outputs rewards/gains are (T_r, B, A) int64 with
// -1 / -1000 padding past the EOS-truncated length.
void lvsr_batch_reward_gain(const int64_t* groundtruth,
                            const int64_t* recognized, int64_t T_g,
                            int64_t T_r, int64_t B, int64_t A, int64_t eos,
                            int64_t* rewards, int64_t* gains) {
  std::vector<int64_t> y(T_g), y_hat(T_r), reward, gain;
  for (int64_t b = 0; b < B; ++b) {
    int64_t n = T_g;
    for (int64_t t = 0; t < T_g; ++t) {
      y[t] = groundtruth[t * B + b];
      if (y[t] == eos && n == T_g) n = t + 1;  // truncate at first EOS
    }
    int64_t m = T_r;
    for (int64_t t = 0; t < T_r; ++t) {
      y_hat[t] = recognized[t * B + b];
      if (y_hat[t] == eos && m == T_r) m = t + 1;
    }
    reward_matrix(y.data(), n, y_hat.data(), m, A, eos, reward);
    // gains: G[j] = R[j] - R[j-1][y_hat[j-1]]
    gain = reward;
    for (int64_t j = m; j >= 1; --j) {
      const int64_t taken = reward[(j - 1) * A + y_hat[j - 1]];
      for (int64_t c = 0; c < A; ++c) gain[j * A + c] -= taken;
    }
    // write truncated-minus-last rows, pad the rest
    for (int64_t t = 0; t < T_r; ++t) {
      int64_t* rrow = rewards + (t * B + b) * A;
      int64_t* grow = gains + (t * B + b) * A;
      if (t < m) {  // rows 0..m-1 = matrix rows dropped-last
        std::memcpy(rrow, reward.data() + t * A, A * sizeof(int64_t));
        std::memcpy(grow, gain.data() + t * A, A * sizeof(int64_t));
      } else {
        for (int64_t c = 0; c < A; ++c) {
          rrow[c] = -1;
          grow[c] = -1000;
        }
      }
    }
  }
}

}  // extern "C"
