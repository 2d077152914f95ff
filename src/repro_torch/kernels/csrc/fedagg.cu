// FedALIGN's fused client aggregation for NVIDIA Hopper (sm_90a): one wire
// decoder composed with one reducer in a single launch, over C client rows
// of M parameters.
//
// Replaces the TPU kernel repro/kernels/fedagg.py:fedagg_pallas, whose grid
// cell decodes a [C, block_m] tile in VMEM and reduces it:
//
//   decoders   identity  u[k, m] (f32 or bf16)             (_decode_identity)
//              int8      q[k, m] * scale[k]                 (_decode_int8)
//              topk      the row's (index, value) pairs     (_decode_topk)
//              sketch    s[k, h[m]] * sign[m]               (_decode_sketch)
//   reducers   mean      sum_k wg_k u / sum_k wg_k          (_mean_kernel)
//              dp        sum_k wg_k rs_k u / den + noise * noise_scale / den
//                                                           (_dp_kernel)
//              trimmed_mean, median: a bitonic sort down the client axis,
//              then the surviving order statistics, unweighted
//                                                  (_trimmed_kernel,
//                                                   _median_kernel, _sort_cols)
//
// with wg_k = w_k g_k. Rows with wg_k <= 0 (mean, dp) or g_k <= 0 (sorted
// reducers) are excluded before anything is read from them, so a NaN behind
// a zero gate never leaks, and zero inclusion gives exact zeros. The dense
// decode is never written to device memory: each thread decodes in
// registers (or, for the sorted reducers and the sparse topk wire, in its
// block's shared memory) what it reduces.
//
// Four kernels, each a template over the decoder:
//
// * stream_kernel (mean, dp; identity, int8, sketch). Bound: bytes. Each
//   thread owns VW adjacent columns and walks down the included rows with
//   one wide load per row (16 bytes: 4 f32, 8 bf16, 16 int8), kUnroll rows
//   in flight, the sums in registers. The block compacts the included row
//   indices into shared memory first (one ballot per warp). The sketch rows
//   ([C, dim], ~0.5 MB) stay in L2; the thread's hash and sign values are
//   loaded once.
// * topk_sum_kernel (mean, dp; topk). Bound: bytes, a few MB a round. The
//   encode sorts each row's pairs by index, so a block binary-searches its
//   column range in each included row and adds only those pairs into a
//   shared-memory accumulator, row by row (indices within a row are
//   distinct, so a row's adds never collide).
// * sorted_reg_kernel (trimmed_mean, median; every decoder; P <= 64).
//   Bound: the compare-exchanges. The bitonic network of P = 64 rows is
//   672 exchanges a column, a min and a max each: 0.78 G min / max over
//   60 x 579,402, 0.047 ms at the 64 results a clock per SM that the CUDA
//   programming guide gives f32 compare / min / max on compute capability
//   9.0, just above the 0.042 ms of bytes. The kernel is templated on P:
//   each thread loads its column's P values into registers (its C rows
//   coalesced across the warp, every load issued before the first
//   exchange, +inf for gated-out and pad rows) and runs the reference's
//   (k, j) schedule unrolled at compile time, so every index and direction
//   is a constant and an exchange is one min.NaN and one max.NaN (PTX,
//   sm_80+: a NaN in either operand gives NaN in both, as jnp.minimum /
//   jnp.maximum). The order statistics are an unrolled predicated select
//   (median: elements (n-1)>>1 and n>>1) or an unrolled predicated add over
//   t <= i < n - t in ascending i. The topk wire still fills a [P, cols]
//   tile in shared memory cooperatively (the rows' binary searches for the
//   block's columns run at once, a thread a row); each thread then moves
//   its column into registers. The first version (the shared-memory network below at
//   every P) lost ~9x to this bound on 2 shared loads, 2 stores, ~5 index
//   operations and a runtime direction a compare-exchange.
// * sorted_kernel (the same, 64 < P <= 1024: C > 64), the first version's
//   (its min / max now the same PTX pair). Bound: shared memory. One column per thread, a [P, cols]
//   tile in shared memory laid out so a warp's accesses fall in 32 distinct
//   banks; each thread walks the bitonic network over its own column with
//   NaN-propagating min/max in the reference's (k, j) order, so a NaN lands
//   where the jnp lowering puts it. P is C rounded up to a power of two,
//   padded with +inf.
//
// C interface (bound with ctypes): fedagg_launch() takes a FedaggArgs and
// the stream and returns the launch's cudaError_t; fedagg_error_string()
// names it.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kTopkCols = 2048;    // columns per block of topk_sum_kernel
constexpr int kMaxSortRows = 1024;  // largest P of sorted_kernel
constexpr int kMaxRegRows = 64;     // largest P of sorted_reg_kernel
constexpr int kRegThreads = 128;    // sorted_reg_kernel: threads (= columns) a block
constexpr int kRegBlocks = 5;       // ... and blocks a SM: a budget of 65536 / (5 x 128)
                                    // registers holds P = 64 without spills (6 spills)
constexpr int kMaxSmem = 227 * 1024;

enum Reducer { kMean = 0, kDp = 1, kTrimmed = 2, kMedian = 3 };
enum Codec { kIdentity = 0, kInt8 = 1, kTopk = 2, kSketch = 3 };

// Elements are held as their storage type S: float, int8_t, or uint16_t
// holding the bits of a bf16 (bf16 -> f32 is exact: the bits go to the top).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(uint16_t x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

template <typename S>
__device__ __forceinline__ S from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ uint16_t from_f32<uint16_t>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));  // nearest even, as torch
}

template <int Bytes> struct RawT;
template <> struct RawT<16> { using type = uint4; };
template <> struct RawT<8> { using type = uint2; };
template <> struct RawT<4> { using type = unsigned int; };
template <> struct RawT<2> { using type = unsigned short; };
template <> struct RawT<1> { using type = unsigned char; };

// VW elements moved by one load or store instruction (up to 16 bytes)
template <typename S, int VW>
union Pack {
  typename RawT<sizeof(S) * VW>::type raw;
  S v[VW];
};

template <typename S, int VW>
__device__ __forceinline__ Pack<S, VW> load_pack(const S* p) {
  Pack<S, VW> out;
  out.raw = *reinterpret_cast<const typename RawT<sizeof(S) * VW>::type*>(p);
  return out;
}

// VW outputs from f32, in 16-byte (or narrower) stores
template <typename O, int VW>
__device__ __forceinline__ void store_vec(O* p, const float* v) {
  constexpr int kPer = (sizeof(O) * VW <= 16) ? VW : 16 / static_cast<int>(sizeof(O));
#pragma unroll
  for (int c = 0; c < VW / kPer; ++c) {
    Pack<O, kPer> o;
#pragma unroll
    for (int i = 0; i < kPer; ++i) o.v[i] = from_f32<O>(v[c * kPer + i]);
    *reinterpret_cast<typename RawT<sizeof(O) * kPer>::type*>(p + c * kPer) = o.raw;
  }
}

// NaN-propagating min / max, as jnp.minimum / jnp.maximum (fminf drops NaN):
// one instruction each (min.NaN / max.NaN, sm_80+), a NaN in either operand
// gives a NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The reference's bitonic network over P values held in registers, unrolled
// at compile time: stage (K, J) exchanges each i with bit J clear with
// l = i + J (T with a 0 bit inserted at J enumerates those i), ascending
// where bit K of i is clear. Every index is a constant, so v stays in
// registers.
template <int P, int K, int J, int T>
__device__ __forceinline__ void cmp_exchange(float (&v)[P]) {
  constexpr int i = ((T & ~(J - 1)) << 1) | (T & (J - 1));
  constexpr int l = i | J;
  const float lo = min_nan(v[i], v[l]);
  const float hi = max_nan(v[i], v[l]);
  if constexpr ((i & K) == 0) {
    v[i] = lo;
    v[l] = hi;
  } else {
    v[i] = hi;
    v[l] = lo;
  }
}

template <int P, int K, int J, int... T>
__device__ __forceinline__ void stage(float (&v)[P], std::integer_sequence<int, T...>) {
  (cmp_exchange<P, K, J, T>(v), ...);
}

// stages (K, J), (K, J/2), ..., (K, 1), (2K, K), ... up to K = P
template <int P, int K, int J>
__device__ __forceinline__ void bitonic_from(float (&v)[P]) {
  if constexpr (K <= P) {
    stage<P, K, J>(v, std::make_integer_sequence<int, P / 2>{});
    if constexpr (J > 1) {
      bitonic_from<P, K, J / 2>(v);
    } else {
      bitonic_from<P, 2 * K, K>(v);
    }
  }
}

// ------------------------------------------------------------------ decoders
// Each dense decoder gives f32 values of u[row, col .. col + VW) (load, after
// a per-thread setup of its column state) and of one u[row, m] (load1).

template <typename S, int VW>
struct DecIdentity {
  static constexpr int kVW = VW;
  const S* u;
  long long ld;
  struct Col {};
  __device__ Col setup(long long, long long) const { return {}; }
  __device__ __forceinline__ void load(const Col&, int row, long long col,
                                       float* v) const {
    const Pack<S, VW> p = load_pack<S, VW>(u + static_cast<long long>(row) * ld + col);
#pragma unroll
    for (int i = 0; i < VW; ++i) v[i] = to_f32(p.v[i]);
  }
  __device__ __forceinline__ float load1(int row, long long m) const {
    return to_f32(u[static_cast<long long>(row) * ld + m]);
  }
};

// int8 rows times the row's f32 scale, dequantized in registers
template <int VW>
struct DecInt8 {
  static constexpr int kVW = VW;
  const int8_t* q;
  long long ld;
  const float* scale;
  struct Col {};
  __device__ Col setup(long long, long long) const { return {}; }
  __device__ __forceinline__ void load(const Col&, int row, long long col,
                                       float* v) const {
    const Pack<int8_t, VW> p =
        load_pack<int8_t, VW>(q + static_cast<long long>(row) * ld + col);
    const float s = scale[row];
#pragma unroll
    for (int i = 0; i < VW; ++i) v[i] = to_f32(p.v[i]) * s;
  }
  __device__ __forceinline__ float load1(int row, long long m) const {
    return to_f32(q[static_cast<long long>(row) * ld + m]) * scale[row];
  }
};

// CountSketch estimate: the bucket h[m] of the row, times sign[m]
template <int VW>
struct DecSketch {
  static constexpr int kVW = VW;
  const float* s;
  long long dim;
  const int* h;
  const float* sign;
  struct Col {
    int h[VW];
    float sg[VW];
  };
  __device__ Col setup(long long col, long long M) const {
    Col c;
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      const bool in = col + i < M;
      c.h[i] = in ? h[col + i] : 0;
      c.sg[i] = in ? sign[col + i] : 0.f;
    }
    return c;
  }
  __device__ __forceinline__ void load(const Col& c, int row, long long,
                                       float* v) const {
    const float* r = s + static_cast<long long>(row) * dim;
#pragma unroll
    for (int i = 0; i < VW; ++i) v[i] = r[c.h[i]] * c.sg[i];
  }
  __device__ __forceinline__ float load1(int row, long long m) const {
    return s[static_cast<long long>(row) * dim + h[m]] * sign[m];
  }
};

// top-k pairs: row k holds k (index, value) pairs, indices ascending
struct DecTopk {
  const float* vals;
  const int* idx;
  long long k;
};

// the sparse wire fills a sorted kernel's tile cooperatively, the dense
// ones column by column
template <class Dec> struct IsSparse : std::false_type {};
template <> struct IsSparse<DecTopk> : std::true_type {};

// first position in the ascending row[0 .. n) whose value is >= x
__device__ __forceinline__ long long lower_bound(const int* row, long long n,
                                                 long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (row[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ------------------------------------------------------- included-row staging
// Stage rows c0 .. c0 + kThreads: compact the included ones (in row order)
// into s_row with their contraction weight in s_wg, add their gate weight to
// den (in a fixed order, so every block divides by the same value). dp's
// clip scale is read only for included rows: a NaN scale behind a zero gate
// must not leak. Returns the number of rows staged.
template <bool kDP>
__device__ __forceinline__ int stage_rows(int c0, int C, const float* w,
                                          const float* g, const float* rs,
                                          int* s_row, float* s_wg,
                                          int* s_warp_n, float* s_warp_den,
                                          float& den) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = c0 + tid;
  const float wg = k < C ? w[k] * g[k] : 0.f;
  const bool inc = wg > 0.f;
  const unsigned ballot = __ballot_sync(0xffffffffu, inc);
  float part = wg;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if (lane == 0) {
    s_warp_n[warp] = __popc(ballot);
    s_warp_den[warp] = part;
  }
  __syncthreads();
  int base = 0, n = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    base += i < warp ? s_warp_n[i] : 0;
    n += s_warp_n[i];
    den += s_warp_den[i];
  }
  if (inc) {
    const int pos = base + __popc(ballot & ((1u << lane) - 1u));
    s_row[pos] = k;
    s_wg[pos] = kDP ? wg * rs[k] : wg;
  }
  __syncthreads();
  return n;
}

// mean / dp epilogue for one column: exact 0 without inclusion mass
template <bool kDP>
__device__ __forceinline__ float finish(float acc, float den, const float* noise,
                                        float noise_scale, long long m) {
  if (!(den > 0.f)) return 0.f;
  const float safe = fmaxf(den, 1e-30f);
  if (!kDP) return acc / safe;
  // the reference's order, num / safe + noise * (noise_scale / safe),
  // rounded step by step (no fused multiply-add)
  return __fadd_rn(acc / safe, __fmul_rn(noise[m], noise_scale / safe));
}

// -------------------------------------------------------------- stream kernel
template <class Dec, bool kDP, typename O>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(Dec dec, const float* __restrict__ w,
                  const float* __restrict__ g, const float* __restrict__ rs,
                  const float* __restrict__ noise, float noise_scale,
                  O* __restrict__ out, int C, long long M) {
  constexpr int VW = Dec::kVW;
  __shared__ int s_row[kThreads];
  __shared__ float s_wg[kThreads];
  __shared__ int s_warp_n[kWarps];
  __shared__ float s_warp_den[kWarps];

  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * VW;
  const bool live = col < M;
  const bool full = col + VW <= M;  // else this thread holds the ragged tail
  const typename Dec::Col cs = dec.setup(live ? col : 0, M);

  float acc[VW];
#pragma unroll
  for (int i = 0; i < VW; ++i) acc[i] = 0.f;
  float den = 0.f;

  for (int c0 = 0; c0 < C; c0 += kThreads) {
    const int n = stage_rows<kDP>(c0, C, w, g, rs, s_row, s_wg, s_warp_n,
                                  s_warp_den, den);
    if (full) {
      int j = 0;
      for (; j + kUnroll <= n; j += kUnroll) {
        float v[kUnroll][VW];
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) dec.load(cs, s_row[j + r], col, v[r]);
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) {
          const float wr = s_wg[j + r];
#pragma unroll
          for (int i = 0; i < VW; ++i) acc[i] = fmaf(wr, v[r][i], acc[i]);
        }
      }
      for (; j < n; ++j) {
        float v[VW];
        dec.load(cs, s_row[j], col, v);
        const float wr = s_wg[j];
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] = fmaf(wr, v[i], acc[i]);
      }
    } else if (live) {
      for (int j = 0; j < n; ++j) {  // scalar tail for a ragged M
        const float wr = s_wg[j];
        for (int i = 0; i < VW && col + i < M; ++i)
          acc[i] = fmaf(wr, dec.load1(s_row[j], col + i), acc[i]);
      }
    }
    __syncthreads();  // the next chunk overwrites s_row / s_wg
  }

  if (!live) return;
  float o[VW];
#pragma unroll
  for (int i = 0; i < VW; ++i)  // columns past M (ragged tail) are not stored
    o[i] = finish<kDP>(acc[i], den, noise, noise_scale, col + i < M ? col + i : col);
  if (full) {
    store_vec<O, VW>(out + col, o);
  } else {
    for (int i = 0; i < VW && col + i < M; ++i) out[col + i] = from_f32<O>(o[i]);
  }
}

// ------------------------------------------------------------ topk sum kernel
template <bool kDP>
__global__ void __launch_bounds__(kThreads)
    topk_sum_kernel(DecTopk dec, const float* __restrict__ w,
                    const float* __restrict__ g, const float* __restrict__ rs,
                    const float* __restrict__ noise, float noise_scale,
                    float* __restrict__ out, int C, long long M) {
  __shared__ float s_acc[kTopkCols];
  __shared__ int s_row[kThreads];
  __shared__ float s_wg[kThreads];
  __shared__ long long s_lo[kThreads];
  __shared__ long long s_hi[kThreads];
  __shared__ int s_warp_n[kWarps];
  __shared__ float s_warp_den[kWarps];

  const int tid = threadIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.x) * kTopkCols;
  const long long c1 = c0 + kTopkCols < M ? c0 + kTopkCols : M;
  for (int i = tid; i < kTopkCols; i += kThreads) s_acc[i] = 0.f;
  float den = 0.f;

  for (int r0 = 0; r0 < C; r0 += kThreads) {
    const int n = stage_rows<kDP>(r0, C, w, g, rs, s_row, s_wg, s_warp_n,
                                  s_warp_den, den);
    if (tid < n) {  // this block's column range in each included row
      const int* row = dec.idx + static_cast<long long>(s_row[tid]) * dec.k;
      s_lo[tid] = lower_bound(row, dec.k, c0);
      s_hi[tid] = lower_bound(row, dec.k, c1);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {  // row by row: a row's indices are distinct
      const long long base = static_cast<long long>(s_row[j]) * dec.k;
      const float wr = s_wg[j];
      for (long long p = s_lo[j] + tid; p < s_hi[j]; p += kThreads) {
        const int c = static_cast<int>(dec.idx[base + p] - c0);
        s_acc[c] = fmaf(wr, dec.vals[base + p], s_acc[c]);
      }
      __syncthreads();
    }
  }
  for (long long m = c0 + tid; m < c1; m += kThreads)
    out[m] = finish<kDP>(s_acc[m - c0], den, noise, noise_scale, m);
}

// ----------------------------------------------------- sorted kernel, P <= 64
template <int P, class Dec, bool kMedian, typename O>
__global__ void __launch_bounds__(kRegThreads, kRegBlocks)
    sorted_reg_kernel(Dec dec, const float* __restrict__ g, float trim_frac,
                      O* __restrict__ out, int C, long long M) {
  extern __shared__ float tile[];  // topk: [P][kRegThreads]
  __shared__ unsigned s_inc[2];
  const int tid = threadIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.x) * kRegThreads;
  const long long m = c0 + tid;
  const bool live = m < M;
  const float inf = __int_as_float(0x7f800000);

  // the included rows (gate > 0; unweighted), one bit a row, the same for
  // every column
  if (tid < kMaxRegRows) {
    const unsigned b = __ballot_sync(0xffffffffu, tid < C && g[tid] > 0.f);
    if ((tid & 31) == 0) s_inc[tid >> 5] = b;
  }
  __syncthreads();
  const unsigned long long inc =
      s_inc[0] | (static_cast<unsigned long long>(s_inc[1]) << 32);
  const int n = __popcll(inc);

  float v[P];
  if constexpr (IsSparse<Dec>::value) {
    __shared__ long long s_lo[kMaxRegRows], s_hi[kMaxRegRows];
    // thread r finds this block's columns in included row r (all rows'
    // binary searches at once), then each warp places the pairs of its
    // rows; indices within a row are distinct, so no two writes collide
    const long long c1 = c0 + kRegThreads < M ? c0 + kRegThreads : M;
    if (tid < C && (inc >> tid & 1)) {
      const int* row = dec.idx + static_cast<long long>(tid) * dec.k;
      s_lo[tid] = lower_bound(row, dec.k, c0);
      s_hi[tid] = lower_bound(row, dec.k, c1);
    }
    float* col = tile + tid;
#pragma unroll
    for (int r = 0; r < P; ++r) col[r * kRegThreads] = (inc >> r & 1) ? 0.f : inf;
    __syncthreads();
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < C; r += kRegThreads / 32) {
      if (!(inc >> r & 1)) continue;
      const long long base = static_cast<long long>(r) * dec.k;
      for (long long p = s_lo[r] + lane; p < s_hi[r]; p += 32)
        tile[r * kRegThreads + (dec.idx[base + p] - c0)] = dec.vals[base + p];
    }
    __syncthreads();
    if (!live) return;
#pragma unroll
    for (int r = 0; r < P; ++r) v[r] = col[r * kRegThreads];
  } else {
    if (!live) return;
    const typename Dec::Col cs = dec.setup(m, M);
#pragma unroll
    for (int r = 0; r < P; ++r) {
      v[r] = inf;
      if (inc >> r & 1) dec.load(cs, r, m, &v[r]);
    }
  }

  bitonic_from<P, 2, 1>(v);

  float res;
  if constexpr (kMedian) {
    const int lo = (n - 1) >> 1, hi = n >> 1;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      a = i == lo ? v[i] : a;
      b = i == hi ? v[i] : b;
    }
    res = n > 0 ? 0.5f * (a + b) : 0.f;
  } else {
    // t = int32(float32(trim_frac) * float32(n)), as the reference
    const int t = static_cast<int>(__fmul_rn(trim_frac, static_cast<float>(n)));
    const int cnt = n - 2 * t;
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) total = (i >= t && i < n - t) ? total + v[i] : total;
    res = cnt > 0 ? total / static_cast<float>(cnt) : 0.f;
  }
  out[m] = from_f32<O>(res);
}

// -------------------------------------------------------------- sorted kernel
template <class Dec, bool kMedian, typename O>
__global__ void sorted_kernel(Dec dec, const float* __restrict__ g,
                              float trim_frac, O* __restrict__ out, int C,
                              int P, long long M) {
  extern __shared__ float tile[];  // [P][cols], element (r, c) at r * cols + c
  __shared__ unsigned char s_inc[kMaxSortRows];
  const int tid = threadIdx.x;
  const int cols = blockDim.x;
  const long long c0 = static_cast<long long>(blockIdx.x) * cols;
  const long long m = c0 + tid;
  const bool live = m < M;
  const float inf = __int_as_float(0x7f800000);

  int n = 0;  // included count (gate > 0; unweighted)
  for (int r0 = 0; r0 < P; r0 += cols) {
    const int r = r0 + tid;
    const bool inc = r < C && g[r] > 0.f;
    if (r < P) s_inc[r] = inc;
    n += __syncthreads_count(inc);
  }

  float* col = tile + tid;
  if constexpr (IsSparse<Dec>::value) {
    for (int r = 0; r < P; ++r) col[r * cols] = s_inc[r] ? 0.f : inf;
    __syncthreads();
    // each warp places the pairs of its rows that land in this block's
    // columns; indices within a row are distinct, so no two writes collide
    const long long c1 = c0 + cols < M ? c0 + cols : M;
    const int lane = tid & 31, warp = tid >> 5, nwarps = cols >> 5;
    for (int r = warp; r < C; r += nwarps) {
      if (!s_inc[r]) continue;
      const int* row = dec.idx + static_cast<long long>(r) * dec.k;
      const long long lo = lower_bound(row, dec.k, c0);
      const long long hi = lower_bound(row, dec.k, c1);
      for (long long p = lo + lane; p < hi; p += 32)
        tile[r * cols + (row[p] - c0)] = dec.vals[static_cast<long long>(r) * dec.k + p];
    }
    __syncthreads();
  } else {
    for (int r = 0; r < P; ++r)
      col[r * cols] = (live && s_inc[r]) ? dec.load1(r, m) : inf;
  }
  if (!live) return;

  // bitonic network over this thread's column, the reference's schedule;
  // stage (k, j) exchanges each i that has bit j clear with l = i + j (t
  // with a 0 bit inserted at j enumerates those i; the pairs are disjoint,
  // so their order within a stage does not matter)
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll 4
      for (int t = 0; t < P / 2; ++t) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i | j;
        const float a = col[i * cols], b = col[l * cols];
        const float lo = min_nan(a, b), hi = max_nan(a, b);
        const bool asc = (i & k) == 0;
        col[i * cols] = asc ? lo : hi;
        col[l * cols] = asc ? hi : lo;
      }
    }
  }

  float res;
  if (kMedian) {
    res = n > 0 ? 0.5f * (col[((n - 1) >> 1) * cols] + col[(n >> 1) * cols]) : 0.f;
  } else {
    // t = int32(float32(trim_frac) * float32(n)), as the reference
    const int t = static_cast<int>(__fmul_rn(trim_frac, static_cast<float>(n)));
    const int cnt = n - 2 * t;
    float total = 0.f;
    for (int i = t; i < n - t; ++i) total += col[i * cols];
    res = cnt > 0 ? total / static_cast<float>(cnt) : 0.f;
  }
  out[m] = from_f32<O>(res);
}

}  // namespace

extern "C" {

// Mirrors FedaggArgs in kernels/fedagg.py (same field order and types).
struct FedaggArgs {
  const void* u;              // identity/int8: [C, ld] rows; topk: [C, k]
                              // f32 values; sketch: [C, ld] f32 rows
  const float* w;             // [C] data fractions
  const float* g;             // [C] gates
  const float* row_scale;     // dp: [C] clip factors
  const float* noise;         // dp: [M] standard-normal draws
  const float* dequant_scale; // int8: [C]
  const int* topk_idx;        // topk: [C, k], each row ascending
  const int* sketch_h;        // sketch: [M] buckets in [0, ld)
  const float* sketch_sign;   // sketch: [M]
  void* out;                  // [M]: identity keeps the dtype, else f32
  long long ld;               // row pitch of u (elements); k for topk
  long long M;
  float noise_scale;
  float trim_frac;
  int reducer;                // Reducer
  int codec;                  // Codec
  int dtype;                  // identity: 0 float32, 1 bfloat16
  int vw;                     // stream_kernel columns per thread
  int C;
  int sort_cols;              // sorted_kernel threads (= columns) per block
};

}  // extern "C"

namespace {

template <class Dec, bool kDP, typename O>
cudaError_t launch_stream(const FedaggArgs& a, Dec dec, cudaStream_t s) {
  const long long per_block = static_cast<long long>(kThreads) * Dec::kVW;
  const long long blocks = (a.M + per_block - 1) / per_block;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  stream_kernel<Dec, kDP, O><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      dec, a.w, a.g, a.row_scale, a.noise, a.noise_scale,
      static_cast<O*>(a.out), a.C, a.M);
  return cudaGetLastError();
}

template <bool kDP>
cudaError_t launch_mean_or_dp(const FedaggArgs& a, cudaStream_t s) {
  switch (a.codec) {
    case kIdentity:
      if (a.dtype == 0) {
        using F = float;
        const auto* u = static_cast<const F*>(a.u);
        switch (a.vw) {
          case 4: return launch_stream<DecIdentity<F, 4>, kDP, F>(a, {u, a.ld}, s);
          case 2: return launch_stream<DecIdentity<F, 2>, kDP, F>(a, {u, a.ld}, s);
          case 1: return launch_stream<DecIdentity<F, 1>, kDP, F>(a, {u, a.ld}, s);
        }
      } else if (a.dtype == 1) {
        using B = uint16_t;
        const auto* u = static_cast<const B*>(a.u);
        switch (a.vw) {
          case 8: return launch_stream<DecIdentity<B, 8>, kDP, B>(a, {u, a.ld}, s);
          case 4: return launch_stream<DecIdentity<B, 4>, kDP, B>(a, {u, a.ld}, s);
          case 2: return launch_stream<DecIdentity<B, 2>, kDP, B>(a, {u, a.ld}, s);
          case 1: return launch_stream<DecIdentity<B, 1>, kDP, B>(a, {u, a.ld}, s);
        }
      }
      break;
    case kInt8: {
      const auto* q = static_cast<const int8_t*>(a.u);
      switch (a.vw) {
        case 16: return launch_stream<DecInt8<16>, kDP, float>(a, {q, a.ld, a.dequant_scale}, s);
        case 4: return launch_stream<DecInt8<4>, kDP, float>(a, {q, a.ld, a.dequant_scale}, s);
        case 1: return launch_stream<DecInt8<1>, kDP, float>(a, {q, a.ld, a.dequant_scale}, s);
      }
      break;
    }
    case kSketch: {
      const auto* sk = static_cast<const float*>(a.u);
      switch (a.vw) {
        case 4: return launch_stream<DecSketch<4>, kDP, float>(a, {sk, a.ld, a.sketch_h, a.sketch_sign}, s);
        case 1: return launch_stream<DecSketch<1>, kDP, float>(a, {sk, a.ld, a.sketch_h, a.sketch_sign}, s);
      }
      break;
    }
    case kTopk: {
      const long long blocks = (a.M + kTopkCols - 1) / kTopkCols;
      if (blocks > INT_MAX) return cudaErrorInvalidValue;
      const DecTopk dec{static_cast<const float*>(a.u), a.topk_idx, a.ld};
      topk_sum_kernel<kDP><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          dec, a.w, a.g, a.row_scale, a.noise, a.noise_scale,
          static_cast<float*>(a.out), a.C, a.M);
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

template <int P, class Dec, bool kMedian, typename O>
cudaError_t launch_sorted_reg(const FedaggArgs& a, Dec dec, cudaStream_t s) {
  const long long blocks = (a.M + kRegThreads - 1) / kRegThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem =
      IsSparse<Dec>::value ? static_cast<size_t>(P) * kRegThreads * sizeof(float) : 0;
  sorted_reg_kernel<P, Dec, kMedian, O>
      <<<static_cast<unsigned>(blocks), kRegThreads, smem, s>>>(
          dec, a.g, a.trim_frac, static_cast<O*>(a.out), a.C, a.M);
  return cudaGetLastError();
}

template <class Dec, bool kMedian, typename O>
cudaError_t launch_sorted(const FedaggArgs& a, Dec dec, cudaStream_t s) {
  int P = 1;
  while (P < a.C) P <<= 1;
  switch (P) {
    case 1: return launch_sorted_reg<1, Dec, kMedian, O>(a, dec, s);
    case 2: return launch_sorted_reg<2, Dec, kMedian, O>(a, dec, s);
    case 4: return launch_sorted_reg<4, Dec, kMedian, O>(a, dec, s);
    case 8: return launch_sorted_reg<8, Dec, kMedian, O>(a, dec, s);
    case 16: return launch_sorted_reg<16, Dec, kMedian, O>(a, dec, s);
    case 32: return launch_sorted_reg<32, Dec, kMedian, O>(a, dec, s);
    case 64: return launch_sorted_reg<64, Dec, kMedian, O>(a, dec, s);
  }
  const int cols = a.sort_cols;
  const size_t smem = static_cast<size_t>(P) * cols * sizeof(float);
  if (P > kMaxSortRows || cols < 32 || cols > 1024 || cols % 32 != 0 ||
      smem > static_cast<size_t>(kMaxSmem) - kMaxSortRows)
    return cudaErrorInvalidValue;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sorted_kernel<Dec, kMedian, O>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem - kMaxSortRows);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const long long blocks = (a.M + cols - 1) / cols;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  sorted_kernel<Dec, kMedian, O><<<static_cast<unsigned>(blocks), cols, smem, s>>>(
      dec, a.g, a.trim_frac, static_cast<O*>(a.out), a.C, P, a.M);
  return cudaGetLastError();
}

template <bool kMedian>
cudaError_t launch_sorted_codec(const FedaggArgs& a, cudaStream_t s) {
  switch (a.codec) {
    case kIdentity:
      if (a.dtype == 0)
        return launch_sorted<DecIdentity<float, 1>, kMedian, float>(
            a, {static_cast<const float*>(a.u), a.ld}, s);
      if (a.dtype == 1)
        return launch_sorted<DecIdentity<uint16_t, 1>, kMedian, uint16_t>(
            a, {static_cast<const uint16_t*>(a.u), a.ld}, s);
      break;
    case kInt8:
      return launch_sorted<DecInt8<1>, kMedian, float>(
          a, {static_cast<const int8_t*>(a.u), a.ld, a.dequant_scale}, s);
    case kSketch:
      return launch_sorted<DecSketch<1>, kMedian, float>(
          a, {static_cast<const float*>(a.u), a.ld, a.sketch_h, a.sketch_sign}, s);
    case kTopk:
      return launch_sorted<DecTopk, kMedian, float>(
          a, {static_cast<const float*>(a.u), a.topk_idx, a.ld}, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int fedagg_launch(const FedaggArgs* a, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (a->C < 0 || a->M < 0 || a->ld < 0) return cudaErrorInvalidValue;
  if (a->M == 0) return cudaSuccess;
  switch (a->reducer) {
    case kMean: return launch_mean_or_dp<false>(*a, s);
    case kDp: return launch_mean_or_dp<true>(*a, s);
    case kTrimmed: return launch_sorted_codec<false>(*a, s);
    case kMedian: return launch_sorted_codec<true>(*a, s);
  }
  return cudaErrorInvalidValue;
}

const char* fedagg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
