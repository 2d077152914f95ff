// Decode attention for NVIDIA Hopper (sm_90a): one query token per
// sequence against a KV cache with kv_len valid rows, grouped-query heads.
//
//   q [B, 1, H, hd]; k, v caches [B, Skv, KV, hd] (f32 or bf16, one dtype);
//   query head h reads kv head h / G (G = H / KV); rows [0, kv_len) count,
//   in any order (under a sliding window the cache is a ring);
//   out [B, 1, H, hd] (q's dtype) = softmax(q k^T * scale) v.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:
// decode_attention_pallas (_kernel), whose grid is (B, KV, kv blocks) with
// the online-softmax state of a kv head's G query heads in VMEM scratch, so
// each kv row is read once; kv_len arrives by scalar prefetch. Here kv_len
// is a plain kernel argument (the caller keeps the position a host
// integer, so a decode step never waits on the device).
//
// Numerics as in the reference: f32 scores, softmax state and sums (expf),
// one rounding of acc / l to q's dtype. The reference masks rows >= kv_len
// with -1e30, which gives them weight exp(-1e30 - m) = 0; here they are not
// read at all.
//
// Bound: bytes. A call reads the kv_len valid rows of both caches once.
// Design, both routes:
// - Grid (n_split, B * KV * chunks), one block a (batch, kv head, chunk of
//   GT <= 8 query heads): the block serves all the group's query heads, so
//   each kv row is read from device memory once (G > 8 takes ceil(G / 8)
//   chunks, each reading the rows again).
// - The n_split (a power of two <= 8) blocks of a (batch, kv head, chunk)
//   form one thread-block cluster; block s takes rows [s * keys_per_split,
//   ...). Its 8 warps take 16-row tiles in turn; each warp keeps its own
//   online state (m, l, acc) and its own ring of 17 KB of tiles (2 at hd
//   128 in bf16, 3 at hd 64) filled by cp.async 16-byte copies (bf16 stays
//   bf16 in shared memory), so 16-24 tiles of a block are in flight at once
//   and no block barrier sits in the row loop.
// - One launch: the warps' states merge in shared memory (warp order), then
//   the cluster's blocks merge through distributed shared memory: the
//   weights exp(m_s - M) once per (head, split), then each block writes a
//   share of the GT * hd outputs, summing the splits in split order.
// bf16, on the tensor cores (mma.sync m16n8k16, f32 accumulators): scores
//   S^T = Q K^T with the GT query heads as the rows (16, padded with zero
//   rows) and 8 keys a product, from unscaled bf16 q and k (each product
//   exact in f32), times scale in f32; the 4 scores a lane holds are of one
//   head, so the tile's max takes 2 shuffles. P goes from the score
//   registers straight into O^T = V^T P^T (hd rows, the heads as 8
//   columns), split into bf16 hi + lo, two products into one f32 sum, so the
//   reference's f32 P is kept to ~2^-16. Rows are padded by 16 bytes in
//   shared memory, so ldmatrix reads them without bank conflicts.
// f32, on the CUDA cores (the parity checks' route): a lane owns hd / 32
//   columns, holds q * scale (f32) of them for the GT heads, and the GT
//   accumulators of those columns. A score is the lane's fma chain over its
//   columns, then a butterfly reduce-scatter of 32 partials (GT heads x
//   32 / GT keys) leaves each lane one whole score; p goes to shared memory
//   and every lane adds p * v over its columns.
//
// C interface (bound with ctypes): decode_attention_launch() returns the
// launch's cudaError_t; decode_attention_floor_launch() launches an empty
// kernel of the same grid, cluster, block and shared memory (the launch
// floor a timing compares with); decode_attention_error_string() names an
// error.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;            // keys per warp tile
constexpr int kMaxSplit = 8;         // blocks a cluster (the portable most)
constexpr int kRingBytes = 17408;    // shared memory a warp's ring may take:
                                     // two bf16 tiles at hd 128
constexpr float kNegInf = -1e30f;    // the running max before any key

__device__ __forceinline__ float minus_inf() { return __int_as_float(0xff800000); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// 16 bytes, or 16 zero bytes when !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long k_sb, k_ss, v_sb, v_ss;   // batch / seq strides of the caches
  int H, KV, G, chunks, kv_len, keys_per_split;
  float scale;
};

constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }
constexpr int clamp_stages(int n) { return n < 1 ? 1 : n > 4 ? 4 : n; }

// Shared memory of the merges, after the ring: the block's merged state
// red (acc [GT][HD], m [GT], l [GT]), the weights [GT][<= 16] and the
// heads' final l [GT].
template <int HD, int GT>
struct MergeSmem {
  static constexpr int kPart = GT * HD + 2 * GT;        // a state: acc [GT][HD], m [GT], l [GT]
  static constexpr int kWeights = GT * (kWarps > kMaxSplit ? kWarps : kMaxSplit);
  static constexpr int kFloats = kPart + kWeights + GT;
};

// Each warp has written its state at parts + warp * kPart (m = kNegInf,
// l = 0, acc = 0 when it had no tile). Merge the warps (weights exp(m_w -
// M) per head, l as a butterfly over the warps, acc as an fma chain in
// warp order), then the cluster's blocks (the same over the splits, read
// through distributed shared memory), and write this block's share of the
// outputs, rounded once.
template <typename T, int HD, int GT>
__device__ __forceinline__ void merge_and_store(const float* parts, float* red, const Args& a,
                                                int b, int h0, int gv) {
  constexpr int kPart = MergeSmem<HD, GT>::kPart;
  float* wts = red + kPart;                               // [GT][warps or splits] weights
  float* lsum = wts + MergeSmem<HD, GT>::kWeights;        // [GT]
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = static_cast<int>(threadIdx.x);
  const int split = static_cast<int>(blockIdx.x);         // = the block's rank in its cluster
  const int n_split = static_cast<int>(gridDim.x);
  __syncthreads();
  {                                                       // warps: (head, warp) per thread
    const int g = tid / kWarps, w = tid % kWarps;
    const bool on = g < GT;
    const float mw = on ? parts[w * kPart + GT * HD + g] : kNegInf;
    float mx = mw;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float wt = expf(mw - mx);
    float l = on ? parts[w * kPart + GT * HD + GT + g] * wt : 0.0f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (on) {
      wts[g * kWarps + w] = wt;
      if (w == 0) {
        red[GT * HD + g] = mx;
        red[GT * HD + GT + g] = l;
      }
    }
  }
  __syncthreads();
  T* op = static_cast<T*>(a.out) + (static_cast<long long>(b) * a.H + h0) * HD;
  for (int e = tid; e < GT * HD; e += kThreads) {
    const int g = e / HD;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum = fmaf(parts[w * kPart + e], wts[g * kWarps + w], sum);
    red[e] = sum;
    // one split: its weight is exp(0) = 1, so the output is this sum
    if (n_split == 1 && g < gv) op[e] = from_f<T>(sum / fmaxf(red[GT * HD + GT + g], 1e-30f));
  }
  if (n_split == 1) return;
  cluster.sync();                                         // every block's red is written
  {                                                       // splits: (head, split) per thread
    const int g = tid / n_split, r = tid % n_split;
    const bool on = g < GT;
    const float* rr = cluster.map_shared_rank(red, on ? r : 0);
    const float mr = on ? rr[GT * HD + g] : kNegInf;
    float mx = mr;
    for (int o = n_split / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float wt = expf(mr - mx);
    float l = on ? rr[GT * HD + GT + g] * wt : 0.0f;
    for (int o = n_split / 2; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (on) {
      wts[g * n_split + r] = wt;
      if (r == 0) lsum[g] = l;
    }
  }
  __syncthreads();
  for (int e = split * kThreads + tid; e < gv * HD; e += n_split * kThreads) {
    const int g = e / HD;
    float v[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)                   // every load issued before the sum
      if (r < n_split) v[r] = cluster.map_shared_rank(red, r)[e];
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      if (r < n_split) sum = fmaf(v[r], wts[g * n_split + r], sum);
    op[e] = from_f<T>(sum / fmaxf(lsum[g], 1e-30f));
  }
  cluster.sync();                                         // no block leaves while others read it
}

// Compile-time layout of the f32 CUDA-core route for one (hd, heads per
// block).
template <int HD, int GT>
struct Plan {
  static constexpr int kC = HD / 32;                    // columns a lane owns
  static constexpr int kV = (kC == 3) ? 1 : kC;         // columns per vector load
  static constexpr int kChunks = kC / kV;               // column col = (ch * 32 + lane) * kV + e
  static constexpr int kNB = (kTile * GT < 32) ? kTile * GT : 32;   // values a reduce-scatter takes
  static constexpr int kNKB = kNB / GT;                 // keys per batch
  static constexpr int kBatches = kTile / kNKB;
  static constexpr int kShift = 5 - log2i(kNB);         // replica bits of the lane index
  static constexpr int kLogG = log2i(GT);
  static constexpr int kStageElems = 2 * kTile * HD;    // k tile then v tile
  static constexpr int kStageBytes = kStageElems * 4;
  static constexpr int kStages = clamp_stages(kRingBytes / kStageBytes);
  static constexpr int kRowChunks = HD / 4;             // 16-byte copies a row
  static constexpr int kRingFloats = kWarps * kStages * kStageBytes / 4;
  static constexpr int kPs = kTile * GT + GT;           // a warp's p [kTile][GT] and corr [GT]
  static constexpr size_t kSmem =
      (static_cast<size_t>(kRingFloats) + kWarps * kPs + MergeSmem<HD, GT>::kFloats) * sizeof(float);
  static_assert(kTile * GT % kNB == 0 && kNB % GT == 0, "batches tile the keys");
  static_assert(kWarps * MergeSmem<HD, GT>::kPart <= kRingFloats, "warp states fit in the ring");
  static_assert(HD % 32 == 0 && (kC <= 4), "hd in {32, 64, 96, 128}");
};

// Butterfly reduce-scatter of N values across the warp, lane bit O first:
// a lane keeps the half its bit selects, adding its partner's copy; once
// one value is left, the remaining bits are an all-reduce. Lane l ends with
// the warp's sum of value l >> (5 - log2 N). Compile-time indices only, so
// the values stay in registers.
template <int N, int O>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float* vals, int lane) {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const float send = upper ? vals[e] : vals[e + N / 2];
      const float keep = upper ? vals[e + N / 2] : vals[e];
      vals[e] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    ReduceScatter<N / 2, O / 2>::run(vals, lane);
  }
};
template <int O>
struct ReduceScatter<1, O> {
  static __device__ __forceinline__ void run(float* vals, int) {
#pragma unroll
    for (int o = O; o > 0; o >>= 1) vals[0] += __shfl_xor_sync(0xffffffffu, vals[0], o);
  }
};

// Copy a warp's tile (keys [r0, r0 + n) of the block's range, n <= kTile)
// of both caches into one ring stage, 16 bytes a copy.
template <int HD, int GT>
__device__ __forceinline__ void load_tile(float* stage, const float* kb, const float* vb,
                                          long long k_ss, long long v_ss, int r0, int n,
                                          int lane) {
  using P = Plan<HD, GT>;
  for (int idx = lane; idx < n * P::kRowChunks; idx += 32) {
    const int r = idx / P::kRowChunks;
    const int c = (idx % P::kRowChunks) * 4;
    cp_async16(stage + r * HD + c, kb + (r0 + r) * k_ss + c);
    cp_async16(stage + (kTile + r) * HD + c, vb + (r0 + r) * v_ss + c);
  }
}

// A lane's kC columns of shared row `row` as f32.
template <int HD, int GT>
__device__ __forceinline__ void row_cols(const float* row, int lane, float* f) {
  using P = Plan<HD, GT>;
#pragma unroll
  for (int ch = 0; ch < P::kChunks; ++ch) {
    const Vec<float, P::kV> a =
        *reinterpret_cast<const Vec<float, P::kV>*>(row + (ch * 32 + lane) * P::kV);
#pragma unroll
    for (int e = 0; e < P::kV; ++e) f[ch * P::kV + e] = a.v[e];
  }
}

template <int HD, int GT>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(Args a) {
  using P = Plan<HD, GT>;
  constexpr int kC = P::kC;
  constexpr int kPart = MergeSmem<HD, GT>::kPart;
  extern __shared__ __align__(16) float smem[];
  float* ring_f = smem;                                   // [kWarps][kStages] stages; later the warp states
  float* ps_all = smem + P::kRingFloats;                  // [kWarps][kPs]
  float* red = ps_all + kWarps * P::kPs;                  // MergeSmem
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int split = static_cast<int>(blockIdx.x);
  const int y = static_cast<int>(blockIdx.y);
  const int chunk = y % a.chunks;
  const int bk = y / a.chunks;
  const int b = bk / a.KV;
  const int kvh = bk % a.KV;
  const int h0 = kvh * a.G + chunk * GT;                  // first query head of the block
  const int gv = min(GT, a.G - chunk * GT);               // heads that are real (the rest pad)
  const int j0 = split * a.keys_per_split;
  const int j1 = min(a.kv_len, j0 + a.keys_per_split);

  // q * scale (f32) of the lane's columns for the GT heads
  float qr[GT][kC];
  const float* qp = static_cast<const float*>(a.q) + (static_cast<long long>(b) * a.H + h0) * HD;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < gv) {
      row_cols<HD, GT>(qp + g * HD, lane, qr[g]);
#pragma unroll
      for (int c = 0; c < kC; ++c) qr[g][c] *= a.scale;
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c) qr[g][c] = 0.0f;
    }
  }

  // the lane's (key, head) after a reduce-scatter: value index kk * GT + g
  const int vidx = lane >> P::kShift;
  const int my_g = vidx % GT;
  const int my_kk = vidx / GT;
  const bool writer = (lane & ((1 << P::kShift) - 1)) == 0;

  float acc[GT][kC];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[g][c] = 0.0f;
  float m = kNegInf;            // running max of head my_g
  float l_part = 0.0f;          // the lane's share of its head's sum of p

  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + static_cast<long long>(kvh) * HD + j0 * a.k_ss;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + static_cast<long long>(kvh) * HD + j0 * a.v_ss;
  float* ring = ring_f + warp * P::kStages * P::kStageElems;
  float* ps = ps_all + warp * P::kPs;
  float* corr_s = ps + kTile * GT;

  const int n_rows = j1 - j0;
  const int n_tiles = (n_rows + kTile - 1) / kTile;
  const int my_tiles = warp < n_tiles ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  auto issue = [&](int i) {     // the warp's i-th tile into stage i % kStages
    if (i < my_tiles) {
      const int r0 = (warp + i * kWarps) * kTile;
      load_tile<HD, GT>(ring + (i % P::kStages) * P::kStageElems, kb, vb, a.k_ss, a.v_ss,
                           r0, min(kTile, n_rows - r0), lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < P::kStages - 1; ++i) issue(i);

  for (int i = 0; i < my_tiles; ++i) {
    issue(i + P::kStages - 1);
    cp_async_wait<P::kStages - 1>();
    __syncwarp();
    const float* ks = ring + (i % P::kStages) * P::kStageElems;
    const float* vs = ks + kTile * HD;
    const int nvalid = min(kTile, n_rows - (warp + i * kWarps) * kTile);

    float s[P::kBatches];
#pragma unroll
    for (int bt = 0; bt < P::kBatches; ++bt) {
      float vals[P::kNB];
#pragma unroll
      for (int kk = 0; kk < P::kNKB; ++kk) {
        float kf[kC];
        row_cols<HD, GT>(ks + (bt * P::kNKB + kk) * HD, lane, kf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float d = 0.0f;
#pragma unroll
          for (int c = 0; c < kC; ++c) d = fmaf(qr[g][c], kf[c], d);
          vals[kk * GT + g] = d;
        }
      }
      ReduceScatter<P::kNB, 16>::run(vals, lane);
      s[bt] = (bt * P::kNKB + my_kk < nvalid) ? vals[0] : minus_inf();
    }

    // the tile's max per head: over the lane's scores, then the lanes of
    // the same head (they differ in the key bits of the lane index)
    float tmax = s[0];
#pragma unroll
    for (int bt = 1; bt < P::kBatches; ++bt) tmax = fmaxf(tmax, s[bt]);
#pragma unroll
    for (int o = 16; o >= (1 << (P::kShift + P::kLogG)); o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    m = m_new;
    l_part *= corr;
#pragma unroll
    for (int bt = 0; bt < P::kBatches; ++bt) {
      const float p = expf(s[bt] - m_new);                // 0 for the rows past the range
      l_part += p;
      if (writer) ps[(bt * P::kNKB + my_kk) * GT + my_g] = p;
    }
    if (writer && my_kk == 0) corr_s[my_g] = corr;
    __syncwarp();

#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float cg_ = corr_s[g];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[g][c] *= cg_;
    }
    for (int j = 0; j < nvalid; ++j) {
      float vf[kC];
      row_cols<HD, GT>(vs + j * HD, lane, vf);
      const Vec<float, GT> pj = *reinterpret_cast<const Vec<float, GT>*>(ps + j * GT);
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[g][c] = fmaf(pj.v[g], vf[c], acc[g][c]);
    }
    __syncwarp();                                         // the stage and ps are free again
  }
  cp_async_wait<0>();

  // the warp's l per head: the lanes of a head hold disjoint keys
#pragma unroll
  for (int o = 16; o >= (1 << (P::kShift + P::kLogG)); o >>= 1)
    l_part += __shfl_xor_sync(0xffffffffu, l_part, o);

  // the warp's state into the (now idle) ring, then the merges
  __syncthreads();
  float* part = ring_f + warp * kPart;
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int ch = 0; ch < P::kChunks; ++ch)
#pragma unroll
      for (int e = 0; e < P::kV; ++e)
        part[g * HD + (ch * 32 + lane) * P::kV + e] = acc[g][ch * P::kV + e];
  if (writer && my_kk == 0) {
    part[GT * HD + my_g] = m;
    part[GT * HD + GT + my_g] = l_part;
  }
  merge_and_store<float, HD, GT>(ring_f, red, a, b, h0, gv);
}

// ------------------------------------------------ bf16: the tensor cores

__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// two f32 as bf16 (x in the low half: the lower k index of a fragment)
__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int HD, int GT>
struct TcPlan {
  static constexpr int kRow = HD + 8;                   // bf16 a shared row: 16 bytes of pad
  static constexpr int kStageElems = 2 * kTile * kRow;  // k tile then v tile
  static constexpr int kStageBytes = kStageElems * 2;
  static constexpr int kStages = clamp_stages(kRingBytes / kStageBytes);
  static constexpr int kRowChunks = HD / 8;             // 16-byte copies a row
  static constexpr int kK = HD / 16;                    // k-steps of S, m-tiles of O
  static constexpr int kRingFloats = kWarps * kStages * kStageBytes / 4;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kRingFloats) + MergeSmem<HD, GT>::kFloats) * sizeof(float);
  static_assert(kWarps * MergeSmem<HD, GT>::kPart <= kRingFloats, "warp states fit in the ring");
  static_assert(GT <= 8 && HD % 32 == 0, "8 heads a product; k-steps in pairs");
};

// A warp's tile (rows [r0, r0 + n) of the block's range) of both caches
// into one stage of padded rows; rows n..15 are zero-filled (a zero v row
// times p = 0 adds nothing, where stale bits could be NaN).
template <int HD, int GT>
__device__ __forceinline__ void load_tile_tc(__nv_bfloat16* stage, const __nv_bfloat16* kb,
                                             const __nv_bfloat16* vb, long long k_ss,
                                             long long v_ss, int r0, int n, int lane) {
  using P = TcPlan<HD, GT>;
  for (int idx = lane; idx < kTile * P::kRowChunks; idx += 32) {
    const int r = idx / P::kRowChunks;
    const int c = (idx % P::kRowChunks) * 8;
    const bool valid = r < n;
    const long long row = valid ? r0 + r : r0;
    cp_async16(stage + r * P::kRow + c, kb + row * k_ss + c, valid);
    cp_async16(stage + (kTile + r) * P::kRow + c, vb + row * v_ss + c, valid);
  }
}

template <int HD, int GT>
__global__ void __launch_bounds__(kThreads)
decode_attention_tc_kernel(Args a) {
  using P = TcPlan<HD, GT>;
  using bf16 = __nv_bfloat16;
  constexpr int kPart = MergeSmem<HD, GT>::kPart;
  constexpr int kK = P::kK;
  extern __shared__ __align__(16) float smem[];
  float* ring_f = smem;                                   // the warps' rings; later their states
  float* red = smem + P::kRingFloats;                     // MergeSmem

  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int gid = lane >> 2;                              // fragment row group
  const int tig = lane & 3;                               // thread in the group
  const int split = static_cast<int>(blockIdx.x);
  const int y = static_cast<int>(blockIdx.y);
  const int chunk = y % a.chunks;
  const int bk = y / a.chunks;
  const int b = bk / a.KV;
  const int kvh = bk % a.KV;
  const int h0 = kvh * a.G + chunk * GT;
  const int gv = min(GT, a.G - chunk * GT);
  const int j0 = split * a.keys_per_split;
  const int j1 = min(a.kv_len, j0 + a.keys_per_split);

  // Q as the A operand of S^T = Q K^T: row gid = head gid (rows 8-15 and
  // the padded heads zero), k-step ks = columns 16 ks .. 16 ks + 15
  unsigned qa[kK][2];
  const bf16* qp = static_cast<const bf16*>(a.q) + (static_cast<long long>(b) * a.H + h0) * HD;
#pragma unroll
  for (int ks = 0; ks < kK; ++ks) {
    qa[ks][0] = gid < gv ? *reinterpret_cast<const unsigned*>(qp + gid * HD + 16 * ks + 2 * tig) : 0u;
    qa[ks][1] = gid < gv ? *reinterpret_cast<const unsigned*>(qp + gid * HD + 16 * ks + 8 + 2 * tig) : 0u;
  }
  // O^T accumulators: m-tile mt, rows d = 16 mt + gid (+ 8), columns = heads 2 tig, 2 tig + 1
  float acc[kK][4];
#pragma unroll
  for (int mt = 0; mt < kK; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.0f;
  float m = kNegInf;            // running max of head gid
  float l_part = 0.0f;          // the lane's share of its head's sum of p

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + static_cast<long long>(kvh) * HD + j0 * a.k_ss;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + static_cast<long long>(kvh) * HD + j0 * a.v_ss;
  bf16* ring = reinterpret_cast<bf16*>(ring_f) + warp * P::kStages * P::kStageElems;

  const int n_rows = j1 - j0;
  const int n_tiles = (n_rows + kTile - 1) / kTile;
  const int my_tiles = warp < n_tiles ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  auto issue = [&](int i) {     // the warp's i-th tile into stage i % kStages
    if (i < my_tiles) {
      const int r0 = (warp + i * kWarps) * kTile;
      load_tile_tc<HD, GT>(ring + (i % P::kStages) * P::kStageElems, kb, vb, a.k_ss, a.v_ss, r0,
                           min(kTile, n_rows - r0), lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < P::kStages - 1; ++i) issue(i);

  for (int i = 0; i < my_tiles; ++i) {
    issue(i + P::kStages - 1);
    cp_async_wait<P::kStages - 1>();
    __syncwarp();
    const bf16* ks_ = ring + (i % P::kStages) * P::kStageElems;
    const bf16* vs_ = ks_ + kTile * P::kRow;
    const int nvalid = min(kTile, n_rows - (warp + i * kWarps) * kTile);

    // S^T: two products of 8 keys; the lane holds head gid, keys
    // 8 nt + 2 tig + e
    // (even and odd k-steps in two accumulators: shorter product chains)
    float c[2][2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nt][0][e] = c[nt][1][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kK; ks += 2) {
        unsigned kf[4];
        ldmatrix_x4(kf, ks_ + (8 * nt + (lane & 7)) * P::kRow + 16 * (ks + (lane >> 4))
                            + 8 * ((lane >> 3) & 1));
        mma_bf16(c[nt][0], qa[ks][0], 0u, qa[ks][1], 0u, kf[0], kf[1]);
        mma_bf16(c[nt][1], qa[ks + 1][0], 0u, qa[ks + 1][1], 0u, kf[2], kf[3]);
      }
    }
    float s[2][2];
    float tmax = minus_inf();
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dot = c[nt][0][e] + c[nt][1][e];
        s[nt][e] = (8 * nt + 2 * tig + e < nvalid) ? dot * a.scale : minus_inf();
        tmax = fmaxf(tmax, s[nt][e]);
      }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    m = m_new;
    float p[2][2];
    l_part *= corr;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nt][e] = expf(s[nt][e] - m_new);                // 0 for the rows past the range
        l_part += p[nt][e];
      }
    // P^T as the B operand (keys 2 tig + e and 8 + 2 tig + e, head gid),
    // hi and lo halves
    const unsigned bh0 = pack_bf16(p[0][0], p[0][1]);
    const unsigned bh1 = pack_bf16(p[1][0], p[1][1]);
    const __nv_bfloat162 h0v = *reinterpret_cast<const __nv_bfloat162*>(&bh0);
    const __nv_bfloat162 h1v = *reinterpret_cast<const __nv_bfloat162*>(&bh1);
    const unsigned bl0 = pack_bf16(p[0][0] - __low2float(h0v), p[0][1] - __high2float(h0v));
    const unsigned bl1 = pack_bf16(p[1][0] - __low2float(h1v), p[1][1] - __high2float(h1v));
    const float c0 = __shfl_sync(0xffffffffu, corr, (2 * tig) * 4);
    const float c1 = __shfl_sync(0xffffffffu, corr, (2 * tig + 1) * 4);
#pragma unroll
    for (int mt = 0; mt < kK; ++mt) {
      acc[mt][0] *= c0;
      acc[mt][1] *= c1;
      acc[mt][2] *= c0;
      acc[mt][3] *= c1;
      unsigned va[4];
      ldmatrix_x4_trans(va, vs_ + (8 * (lane >> 4) + (lane & 7)) * P::kRow + 16 * mt
                                + 8 * ((lane >> 3) & 1));
      mma_bf16(acc[mt], va[0], va[1], va[2], va[3], bh0, bh1);
      mma_bf16(acc[mt], va[0], va[1], va[2], va[3], bl0, bl1);
    }
    __syncwarp();                                         // the stage is free again
  }
  cp_async_wait<0>();
  l_part += __shfl_xor_sync(0xffffffffu, l_part, 1);      // the head's 4 lanes
  l_part += __shfl_xor_sync(0xffffffffu, l_part, 2);

  __syncthreads();                                        // every warp is done with its ring
  float* part = ring_f + warp * kPart;
#pragma unroll
  for (int mt = 0; mt < kK; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int g = 2 * tig + (e & 1);
      if (g < GT) part[g * HD + 16 * mt + gid + 8 * (e >> 1)] = acc[mt][e];
    }
  if (tig == 0 && gid < GT) {
    part[GT * HD + gid] = m;
    part[GT * HD + GT + gid] = l_part;
  }
  merge_and_store<bf16, HD, GT>(ring_f, red, a, b, h0, gv);
}

__global__ void decode_attention_floor_kernel() {}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, size_t smem, int n_split,
                                  int rows_y, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, rows_y, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename K>
cudaError_t set_attrs(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename K>
cudaError_t launch_kernel(K kern, size_t smem, const Args& a, int n_split, int rows_y,
                          bool floor, bool* attr_set, cudaStream_t s) {
  if (!*attr_set) {             // once per instantiation
    const cudaError_t err = set_attrs(kern, smem);
    if (err != cudaSuccess) return err;
    *attr_set = true;
  }
  if (floor) {                  // shared by every instantiation: set each time
    const cudaError_t err = set_attrs(decode_attention_floor_kernel, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, smem, n_split, rows_y, s);
  const cudaError_t err = floor ? cudaLaunchKernelEx(&cfg, decode_attention_floor_kernel)
                                : cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int HD, int GT>
cudaError_t launch(const Args& a, int dtype, int n_split, int rows_y, bool floor,
                   cudaStream_t s) {
  if (dtype == 1) {
    static bool attr_set = false;
    return launch_kernel(decode_attention_tc_kernel<HD, GT>, TcPlan<HD, GT>::kSmem, a, n_split,
                         rows_y, floor, &attr_set, s);
  }
  static bool attr_set = false;
  return launch_kernel(decode_attention_kernel<HD, GT>, Plan<HD, GT>::kSmem, a,
                       n_split, rows_y, floor, &attr_set, s);
}

template <int HD>
cudaError_t launch_g(const Args& a, int dtype, int gt, int n_split, int rows_y, bool floor,
                     cudaStream_t s) {
  switch (gt) {
    case 1: return launch<HD, 1>(a, dtype, n_split, rows_y, floor, s);
    case 2: return launch<HD, 2>(a, dtype, n_split, rows_y, floor, s);
    case 4: return launch<HD, 4>(a, dtype, n_split, rows_y, floor, s);
    case 8: return launch<HD, 8>(a, dtype, n_split, rows_y, floor, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_hd(const Args& a, int dtype, int hd, int gt, int n_split, int rows_y,
                      bool floor, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_g<32>(a, dtype, gt, n_split, rows_y, floor, s);
    case 64: return launch_g<64>(a, dtype, gt, n_split, rows_y, floor, s);
    case 96: return launch_g<96>(a, dtype, gt, n_split, rows_y, floor, s);
    case 128: return launch_g<128>(a, dtype, gt, n_split, rows_y, floor, s);
    default: return cudaErrorInvalidValue;
  }
}

int checked_launch(const void* q, const void* k, const void* v, void* out, long long k_sb,
                   long long k_ss, long long v_sb, long long v_ss, int B, int H, int KV,
                   int hd, int kv_len, int gt, int keys_per_split, int n_split, float scale,
                   int dtype, bool floor, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || kv_len <= 0 || n_split <= 0
      || n_split > kMaxSplit || (n_split & (n_split - 1)) || keys_per_split <= 0
      || static_cast<long long>(n_split - 1) * keys_per_split >= kv_len
      || static_cast<long long>(n_split) * keys_per_split < kv_len) {
    return cudaErrorInvalidValue;
  }
  const int G = H / KV;
  int want_gt = 1;
  while (want_gt < G && want_gt < 8) want_gt <<= 1;
  if (gt != want_gt) return cudaErrorInvalidValue;
  const int chunks = (G + gt - 1) / gt;
  const long long rows_y = static_cast<long long>(B) * KV * chunks;
  if (rows_y > 65535) return cudaErrorInvalidValue;
  Args a{q, k, v, out, k_sb, k_ss, v_sb, v_ss, H, KV, G, chunks, kv_len, keys_per_split, scale};
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  return launch_hd(a, dtype, hd, gt, n_split, static_cast<int>(rows_y), floor, s);
}

}  // namespace

extern "C" {

// q: contiguous [B, 1, H, hd]; k, v: [B, Skv, KV, hd] with contiguous
// (KV, hd) rows and the given batch / seq strides (elements), every row
// 16-byte aligned; out: contiguous like q. gt: query heads a block serves,
// in {1, 2, 4, 8}: the least power of two >= G = H / KV, or 8 when G > 8.
// The n_split splits (a cluster, a power of two <= 8) cover [0, kv_len) in runs
// of keys_per_split rows, none empty. dtype: 0 float32, 1 bfloat16; hd in
// {32, 64, 96, 128}.
int decode_attention_launch(const void* q, const void* k, const void* v, void* out,
                            long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                            int B, int H, int KV, int hd, int kv_len, int gt,
                            int keys_per_split, int n_split, float scale, int dtype,
                            void* stream) {
  return checked_launch(q, k, v, out, k_sb, k_ss, v_sb, v_ss, B, H, KV, hd, kv_len, gt,
                        keys_per_split, n_split, scale, dtype, false, stream);
}

// The same arguments; launches an empty kernel of the same launch shape.
int decode_attention_floor_launch(const void* q, const void* k, const void* v, void* out,
                                  long long k_sb, long long k_ss, long long v_sb,
                                  long long v_ss, int B, int H, int KV, int hd, int kv_len,
                                  int gt, int keys_per_split, int n_split, float scale,
                                  int dtype, void* stream) {
  return checked_launch(q, k, v, out, k_sb, k_ss, v_sb, v_ss, B, H, KV, hd, kv_len, gt,
                        keys_per_split, n_split, scale, dtype, true, stream);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
