// The wide instances of the GRU scans: gru_scan.cu's forward and
// gru_train.cu's backward at widths whose recurrent weight slices do not
// fit a block's shared memory beside its buffers (D above 448 forward, 384
// backward), up to kWideMaxD.
//
// The cluster, the owned columns and the k-major exchange buffers are
// gru_pull.cuh's.  What changes is where the weights live: a block's slice
// (3*Dp*n floats, 768 KB at D=1000) is in global memory, where the wrapper
// packs it per block (ops/gru_scan.py::pack_forward,
// ops/gru_train.py::pack_backward; zero past D, so the padding stays zero),
// k-major, in tiles of kt rows (ring_rows).  The leading tiles of each of
// the step's two products that fit beside the buffers stay in shared
// memory for the whole scan (resident_tiles); the others stream from L2
// through a ring of kRingMinTiles-kRingMaxTiles tiles in slots of
// kRingChunk tiles (WeightRing): each slot's chunk comes in one TMA bulk
// copy (sm90_async.cuh) that completes the slot's "full" mbarrier, the
// readers wait on it, each warp releases the slot on its "empty" mbarrier
// and the last to arrive copies its next chunk, so no tile costs a block
// barrier.  The stream is the same every step, so it runs ahead across
// the products and the steps: the next product's first chunks land during
// the slice sums, the cluster barrier and the pull.  Each tile's rows are
// split into the products' k slices as the earlier ring of 4 x 8 KB
// cp.async tiles split them, and a thread walks the resident tiles, then
// the streamed ones, in tile order: each output is the same k-ordered fmaf
// sum as before, and a second call repeats bit for bit.  Both directions'
// slices of one layer (24 MB at D=1000) stay in the 50 MB L2 across steps.
//
// What bounds it (tools/torch_profile_gru_wide.py): the products, whose
// FMAs run at about a third of their issue rate; at D=1000 the ring's
// waits (a chunk's copy takes longer than the two slots in flight beside
// the one being read), then the cluster exchanges and the pulls.
#pragma once
#include "gru_pull.cuh"
#include "sm90_async.cuh"

namespace {

constexpr int kWideMaxD = 1024;    // the widest width covered
constexpr int kWideMax8 = 992;     // the widest on 8-block clusters
constexpr int kRingFloats = 2048;  // floats of a tile at most (8 KB)
constexpr int kRingMinTiles = 4;   // the ring every wide layout has room for
constexpr int kRingMaxTiles = 6;   // the ring's share of a layout's room;
                                   // the rest of it resident tiles
constexpr int kRingChunk = 2;      // tiles a slot (one bulk copy)
constexpr int kRingBarFloats = 64; // the stream and its mbarriers
constexpr int kRingWarps = kClusterThreads / 32;  // releases of a slot

// (row, gate column) and (row, state column) items a thread finishes in
// the wide forward with `cluster` blocks: enough for n at kWideMaxD
__host__ __device__ constexpr int wide_gate_items(int cluster) {
  return kGroupRows * 2 * (kWideMaxD / cluster) / kClusterThreads;
}
__host__ __device__ constexpr int wide_cand_items(int cluster) {
  return kGroupRows * (kWideMaxD / cluster) / kClusterThreads;
}

// k rows of a tile of a `cols`-column product over `slices` k slices:
// the same number for every slice, within kRingFloats floats, and an even
// count where a row is not a whole number of 16-byte copies (cols even)
__host__ __device__ inline int ring_rows(int cols, int slices) {
  int per = max(1, kRingFloats / (cols * slices));
  if (cols % 4 != 0 && per * slices % 2 != 0) per = per > 1 ? per - 1 : 2;
  return per * slices;
}

// Tiles resident of a step's two products, of t0 and t1 tiles of f0 and
// f1 floats, in `room` floats: one at a time to the product whose
// resident share is the smaller (the first on a tie), while it fits.
__host__ __device__ inline void resident_tiles(int room, int t0, int f0,
                                               int t1, int f1, int& r0,
                                               int& r1) {
  r0 = r1 = 0;
  for (;;) {
    const bool first = r1 == t1 || (r0 < t0 && r0 * t1 <= r1 * t0);
    if (first ? r0 == t0 : r1 == t1) return;
    const int f = first ? f0 : f1;
    if (f > room) return;
    room -= f;
    ++(first ? r0 : r1);
  }
}

// The ring's part of a layout (offsets in floats, 16-byte aligned), after
// `end`, the block's other buffers: the state and mbarriers (bar), the
// slots (ring), then the resident tiles of product 0 (res) and of product
// 1 (res2); the end of it all (total).  Product p has K_p rows of cols_p
// floats in tiles of kt_p rows.
struct RingLayout {
  int slots, res0, res1;             // slots; resident tiles a product
  int bar, ring, res, res2, total;
};

__host__ __device__ inline RingLayout ring_layout(int end, int K0, int c0,
                                                  int kt0, int K1, int c1,
                                                  int kt1) {
  RingLayout o;
  o.bar = end;
  o.ring = o.bar + kRingBarFloats;
  o.slots = min(kRingMaxTiles * kRingFloats, kMaxSmemFloats - o.ring)
            / (kRingChunk * kRingFloats);
  o.res = o.ring + max(o.slots, 0) * kRingChunk * kRingFloats;
  resident_tiles(kMaxSmemFloats - o.res, (K0 + kt0 - 1) / kt0, kt0 * c0,
                 (K1 + kt1 - 1) / kt1, kt1 * c1, o.res0, o.res1);
  o.res2 = o.res + min(o.res0 * kt0, K0) * c0;
  o.total = o.res2 + min(o.res1 * kt1, K1) * c1;
  return o;
}

// The wide forward's shared memory (offsets in floats, 16-byte aligned):
// gru_pull.cuh's FwdLayout without the weights, plus the ring.
//   h, rh (Dp, kGroupRows)  the state and r * state, k-major
//   z     (kGroupRows, n)   the owned update gates of the step
//   stage the next step's gate inputs (kGroupRows * 2n) and input
//         projections (kGroupRows * n), per item, and the mask of two
//         steps' rows (2 * kGroupRows)
//   part  the products' slice partial sums
//   bar, ring, res, res2   ring_layout's, for the gate product (0) and the
//         candidate product (1)
struct WideLayout {
  int n, Dp, slices_g, slices_c, kt_g, kt_c;
  int h, rh, z, stage, part;
  RingLayout r;
};

__host__ __device__ inline WideLayout wide_layout(int D, int cluster) {
  WideLayout o;
  o.n = owned_columns(D, cluster);
  o.Dp = cluster * o.n;
  o.slices_g = tile_slices(2 * o.n, kMaxSlices);
  o.slices_c = tile_slices(o.n, kMaxSlices);
  o.kt_g = ring_rows(2 * o.n, o.slices_g);
  o.kt_c = ring_rows(o.n, o.slices_c);
  o.h = 0;
  o.rh = o.h + o.Dp * kGroupRows;
  o.z = o.rh + o.Dp * kGroupRows;
  o.stage = o.z + kGroupRows * o.n;
  o.part = o.stage + 3 * kGroupRows * o.n + 2 * kGroupRows;
  o.r = ring_layout(o.part + max(o.slices_g * 2, o.slices_c) * kGroupRows
                        * o.n,
                    o.Dp, 2 * o.n, o.kt_g, o.Dp, o.n, o.kt_c);
  return o;
}

// D up to kWideMaxD (kWideMax8 with 8 blocks: past it the 8-block layout
// keeps a ring of two slots only, and one wave of such clusters ran slower
// at D=1000 than two waves of 16-block ones, tools/torch_bench_gru_ring.py),
// every item of a block with a thread, and the layout with a ring of at
// least kRingMinTiles tiles within `max_smem`.
__host__ inline bool wide_fits(int D, int cluster, int max_smem) {
  if (D < 1 || D > (cluster == 8 ? kWideMax8 : kWideMaxD)
      || (cluster != 8 && cluster != 16))
    return false;
  const WideLayout o = wide_layout(D, cluster);
  return kGroupRows * 2 * o.n <= wide_gate_items(cluster) * kClusterThreads
         && o.r.slots * kRingChunk >= kRingMinTiles
         && (size_t)o.r.total * sizeof(float) <= (size_t)max_smem;
}

// The wide backward's shared memory (gru_train.cu, 16-block clusters):
//   big   (2Dp, kGroupRows)  every block's da slices (rows [0, Dp)), then
//         every block's [du | dr] gate gradients, k-major: pulled from
//   oa    (n, kGroupRows)    the block's own da slice, and
//   og    (2n, kGroupRows)   its own [du | dr] slices, which the peers pull
//   stage (6, kGroupRows * n) the next step's u, r, c, h_prev, dstates
//         and mask, per item
//   part  the products' slice partial sums (slices halved while the
//         layout with a ring of kRingMinTiles does not fit)
//   bar, ring, res, res2   ring_layout's, for the reset path's product
//         (0, K = Dp) and the gate path's (1, K = 2Dp)
struct BwdWideLayout {
  int n, Dp, slices, kt;
  int big, oa, og, stage, part;
  RingLayout r;
};

__host__ __device__ inline BwdWideLayout bwd_wide_layout(int D) {
  constexpr int kCluster = 16;
  BwdWideLayout o;
  o.n = owned_columns(D, kCluster);
  o.Dp = kCluster * o.n;
  o.big = 0;
  o.oa = o.big + 2 * o.Dp * kGroupRows;
  o.og = o.oa + o.n * kGroupRows;
  o.stage = o.og + 2 * o.n * kGroupRows;
  o.part = o.stage + 6 * kGroupRows * o.n;
  for (int cap = kMaxSlices;; cap /= 2) {
    o.slices = tile_slices(o.n, cap);
    if (o.part + o.slices * kGroupRows * o.n + kRingMinTiles * kRingFloats
            <= kMaxSmemFloats || cap == 1)
      break;
  }
  o.kt = ring_rows(o.n, o.slices);
  o.r = ring_layout(o.part + o.slices * kGroupRows * o.n, o.Dp, o.n, o.kt,
                    2 * o.Dp, o.n, o.kt);
  return o;
}

__host__ inline bool bwd_wide_fits(int D, int max_smem) {
  if (D < 1 || D > kWideMaxD) return false;
  const BwdWideLayout o = bwd_wide_layout(D);
  return kGroupRows * o.n <= 2 * kClusterThreads
         && o.r.slots * kRingChunk >= kRingMinTiles
         && (size_t)o.r.total * sizeof(float) <= (size_t)max_smem;
}

// Copy every block's own k-major slices `own` (parts regions of n rows,
// kGroupRows floats a row; this block's too) into `big`: block q's region
// g to the rows [g*Dp + q*n, g*Dp + (q+1)*n).  Four 16-byte loads, remote
// but for this block's own, are in flight per thread before their stores.
template <int kCluster>
__device__ __forceinline__ void pull_slices(cooperative_groups::cluster_group&
                                                cluster,
                                            float* own, float* big, int n,
                                            int Dp, int parts) {
  const int per = n * kGroupRows / 4;             // float4s of one region
  const int count = parts * kCluster * per;
  float4* dst = reinterpret_cast<float4*>(big);
  for (int base = threadIdx.x; base < count; base += 4 * kClusterThreads) {
    float4 v[4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kClusterThreads;
      const int g = i / (kCluster * per), q = (i / per) % kCluster;
      const int w = i % per;
      at[u] = i < count ? g * Dp * kGroupRows / 4 + q * per + w : -1;
      if (at[u] >= 0)
        v[u] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(own, q))[g * per + w];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (at[u] >= 0) dst[at[u]] = v[u];
  }
}

// One product's weights as the ring sees them: (K, cols) k-major in
// global memory, tiles of kt rows, the leading `resident` in shared memory.
struct RingTiles {
  const float* w;
  float* res;
  int cols, K, kt, resident;
};

// The stream, in shared memory at the layout's bar: the step's two
// products, the chunks of up to kRingChunk tiles each streams a step, the
// slots, the stream's length in chunks, the chunks copied so far and the
// next one's place in its step.
struct RingState {
  RingTiles prod[2];
  int chunks[2], depth, total, issued, next;
};
static_assert(sizeof(RingState) <= 24 * sizeof(float), "ring state");

// A block's weight ring.  The stream is every step's streamed tiles of
// product 0, then of product 1, T times, in chunks of up to kRingChunk
// consecutive tiles of one product (one bulk copy each); slot s holds the
// stream's chunks s, s + depth, ...  Every thread keeps the readers' place
// (slot, phase).  Thread 0 copies the first `depth` chunks; after that the
// last warp to release a slot (told by the pending count of the slot's
// empty barrier) copies the stream's next chunk into it: the slots free
// up in the stream's order, so a slot refills as soon as it is free.  The
// ring's memory is found from `bar`, its layout's first float: the stream
// (24 floats), the resident tiles' barrier, the slots' full barriers (the
// slot's chunk has landed) and empty barriers (every warp is done with
// it); the slots kRingBarFloats floats on, kRingChunk * kRingFloats floats
// each.
struct WeightRing {
  float* bar;
  int slot, phase;               // the next streamed chunk's slot and its
                                 // round's parity

  __device__ RingState& state() const {
    return *reinterpret_cast<RingState*>(bar);
  }
  __device__ unsigned long long* res_bar() const {
    return reinterpret_cast<unsigned long long*>(bar + 24);
  }
  __device__ unsigned long long* full() const { return res_bar() + 1; }
  __device__ unsigned long long* empty() const {
    return full() + kRingMaxTiles;
  }
  __device__ float* slot_tiles(int s) const {
    return bar + kRingBarFloats + s * kRingChunk * kRingFloats;
  }

  // copy the stream's next chunk into slot s, completing the slot's full
  // barrier (one thread)
  __device__ void issue(int s) const {
    RingState& st = state();
    const int c = st.next;
    st.next = c + 1 == st.chunks[0] + st.chunks[1] ? 0 : c + 1;
    ++st.issued;
    const int which = c < st.chunks[0] ? 0 : 1;
    const RingTiles& p = st.prod[which];
    const int t0 = p.resident + (which ? c - st.chunks[0] : c) * kRingChunk;
    const unsigned bytes =
        (unsigned)(min(kRingChunk * p.kt, p.K - t0 * p.kt) * p.cols)
        * sizeof(float);
    mbar_arrive_expect_tx(full() + s, bytes);
    bulk_copy(slot_tiles(s), p.w + (size_t)t0 * p.kt * p.cols, bytes,
              full() + s);
  }

  // every thread, before the first product
  __device__ void wait_resident() const { mbar_wait(res_bar(), 0); }

  // the warp is done with the slot of its chunk: arrive on its empty
  // barrier; the last warp copies the stream's next chunk into it, after
  // the acquire that orders every warp's reads before the copy
  __device__ __forceinline__ void release(int depth) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0 && mbar_arrive_last(empty() + slot)) {
      mbar_wait(empty() + slot, phase);
      if (state().issued < state().total) issue(slot);
    }
    if (++slot == depth) {
      slot = 0;
      phase ^= 1;
    }
  }

  // part[(q * kGroupRows + row) * cols + c] = sum over k < K, in slice q of
  // every tile, of x[k * kGroupRows + row] * w[k * cols + c] for product
  // `which`: slice q takes the rows [q*kt/slices, (q+1)*kt/slices) of each
  // tile, the resident tiles first, then the streamed ones from the ring;
  // a thread takes tile_partials' kTileRows x kTileCols tile and adds its
  // slice's rows tile after tile, walking runs of whole tiles with two
  // pointers.  Every thread of the block calls it; the caller puts a
  // barrier between the last read of x or part before the call and the
  // call, and between it and the next use of part.
  __device__ __forceinline__ void product(const float* x, int which,
                                          int slices, float* part) {
    constexpr int R = kTileRows, C = kTileCols;
    const RingTiles p = state().prod[which];
    const int depth = state().depth;
    const int cols = p.cols, K = p.K, kt = p.kt;
    const int tid = threadIdx.x;
    const int tiles = (K + kt - 1) / kt;
    const int groups = cols / C, ntiles = (kGroupRows / R) * groups;
    const bool active = tid < slices * ntiles;
    const int q = tid / ntiles, rem = tid % ntiles;
    const int rg = rem / groups, c = (rem % groups) * C;
    const int per = kt / slices;
    float acc[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i][0] = acc[i][1] = 0.f;
    // x's row at xr and the owned columns' row at wr into registers
    auto load = [&](const float* xr, const float* wr, float (&xs)[R],
                    float2& ws) {
      const float4 lo = *reinterpret_cast<const float4*>(xr);
      const float4 hi = *reinterpret_cast<const float4*>(xr + 4);
      xs[0] = lo.x;
      xs[1] = lo.y;
      xs[2] = lo.z;
      xs[3] = lo.w;
      xs[4] = hi.x;
      xs[5] = hi.y;
      xs[6] = hi.z;
      xs[7] = hi.w;
      ws = *reinterpret_cast<const float2*>(wr);
    };
    auto step = [&](const float (&xs)[R], const float2& ws) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i][0] = fmaf(xs[i], ws.x, acc[i][0]);
        acc[i][1] = fmaf(xs[i], ws.y, acc[i][1]);
      }
    };
    // `rows` of slice q's rows from xr, wr on
    auto rows_of = [&](const float* xr, const float* wr, int rows) {
      int k = 0;
      for (; k + kAhead <= rows; k += kAhead) {
        float xs[kAhead][R];
        float2 ws[kAhead];
#pragma unroll
        for (int s = 0; s < kAhead; ++s)
          load(xr + (k + s) * kGroupRows, wr + (k + s) * cols, xs[s],
               ws[s]);
#pragma unroll
        for (int s = 0; s < kAhead; ++s) step(xs[s], ws[s]);
      }
      for (; k < rows; ++k) {
        float xs[R];
        float2 ws;
        load(xr + k * kGroupRows, wr + k * cols, xs, ws);
        step(xs, ws);
      }
    };
    // tiles t0 .. t0 + count - 1, held one after another from wt on
    auto run = [&](const float* wt, int t0, int count) {
      const float* xr =
          x + ((size_t)t0 * kt + q * per) * kGroupRows + rg * R;
      const float* wr = wt + (size_t)q * per * cols + c;
      // the product's last tile may be short
      const int whole = (t0 + count) * kt > K ? count - 1 : count;
      for (int u = 0; u < whole; ++u) {
        rows_of(xr, wr, per);
        xr += kt * kGroupRows;
        wr += kt * cols;
      }
      if (whole < count)
        rows_of(xr, wr, min(per, K - (t0 + whole) * kt - q * per));
    };
    if (active && p.resident) run(p.res, 0, p.resident);
    for (int t = p.resident; t < tiles; t += kRingChunk) {
      mbar_wait(full() + slot, phase);
      if (active) run(slot_tiles(slot), t, min(kRingChunk, tiles - t));
      release(depth);
    }
    if (!active) return;
    float* out = part + (q * kGroupRows + rg * R) * cols + c;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      out[i * cols] = acc[i][0];
      out[i * cols + 1] = acc[i][1];
    }
  }
};

// Every thread of the block, before any other use of the ring's memory:
// the ring of layout `o` in `smem` for `steps` steps of products p0 and p1
// (their w, cols, K and kt; res and resident are set here).  Thread 0 sets
// up the barriers, copies the resident tiles and the stream's first
// `depth` chunks; wait_resident() before the first product.
__device__ inline WeightRing ring_start(float* smem, const RingLayout& o,
                                        RingTiles p0, RingTiles p1,
                                        int steps) {
  WeightRing ring;
  ring.bar = smem + o.bar;
  ring.slot = ring.phase = 0;
  p0.res = smem + o.res;
  p0.resident = o.res0;
  p1.res = smem + o.res2;
  p1.resident = o.res1;
  if (threadIdx.x == 0) {
    RingState& s = ring.state();
    s.prod[0] = p0;
    s.prod[1] = p1;
    for (int i = 0; i < 2; ++i) {
      const RingTiles& p = s.prod[i];
      s.chunks[i] = ((p.K + p.kt - 1) / p.kt - p.resident + kRingChunk - 1)
                    / kRingChunk;
    }
    s.depth = o.slots;
    s.total = steps * (s.chunks[0] + s.chunks[1]);
    s.issued = s.next = 0;
    mbar_init(ring.res_bar(), 1);
    for (int i = 0; i < o.slots; ++i) {
      mbar_init(ring.full() + i, 1);
      mbar_init(ring.empty() + i, kRingWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned b0 =
        (unsigned)(min(p0.resident * p0.kt, p0.K) * p0.cols) * sizeof(float);
    const unsigned b1 =
        (unsigned)(min(p1.resident * p1.kt, p1.K) * p1.cols) * sizeof(float);
    mbar_arrive_expect_tx(ring.res_bar(), b0 + b1);
    if (b0) bulk_copy(p0.res, p0.w, b0, ring.res_bar());
    if (b1) bulk_copy(p1.res, p1.w, b1, ring.res_bar());
    for (int i = 0; i < o.slots && ring.state().issued < ring.state().total;
         ++i)
      ring.issue(i);
  }
  return ring;
}

}  // namespace
