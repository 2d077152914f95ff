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
// Five kernels:
//
// * stream_kernel (mean, dp; identity, int8; the sketch where
//   sketch_kernel does not take it). Bound: bytes. Each thread owns VW
//   adjacent columns and walks down the included rows, the sums in
//   registers, kUnroll rows' loads (one wide load each) in flight before
//   it adds any of them. The block compacts
//   the included row indices into shared memory first (one ballot per
//   warp), with int8's per-row scales beside them. identity: 16-byte
//   loads, 4 rows in flight; every vw the wrapper picks runs this one
//   route. At the LM round's 8 x 464 M f32 it reads 93.6% of the byte
//   bound (3.1 TB/s); at 60 x 579,402, 77% (f32) and under half (bf16),
//   held by the first and last blocks' latency, not by the bytes in flight.
//   Redesigns measured and not kept, each bit-identical and none faster
//   on the f32 rows the rounds run: a TMA bulk-copy ring fed by a producer
//   warp, per-lane cp.async rings, persistent grids (fixed, or tiles
//   handed out by an atomic), a warp a tile with every tile resident, an
//   L2 evict_first hint (faster warm, slower cold and at the LM round).
//   The order is what the outputs' bits rest on: each column adds its
//   included rows in ascending order, one fmaf a row, from 0; a design
//   that splits a column's rows over threads would change it.
//   int8: 4 columns a thread, 8 rows in flight,
//   the last group of a ragged row count predicated, at most 48 registers
//   so that 5 blocks share an SM (the 566 blocks of 256 at 60 x 579,402 in
//   one wave); each int8 turned into f32 as the float bits 0x4B000080 + q
//   minus 2^23 + 128 (exact, on the integer and FMA pipes, not the
//   conversion unit). The first version's 16 columns a thread launched
//   142 blocks, about one an SM: too few bytes in flight.
// * sketch_kernel (mean, dp; sketch with dim <= 57344, h, sign and the
//   output on 16-byte boundaries). Bound: the bytes of h, sign and the
//   output. The decode is linear and sign is +-1, so
//   sum_k wg_k s[k, h[m]] sign[m] = sign[m] * t[h[m]] with
//   t[b] = sum_k wg_k s[k, b]; both sums run in ascending k and rounding
//   is odd-symmetric, so the two are the same bits (a zero is written as
//   +0, as the decode-first sum gives). One thread-block cluster of 8
//   blocks (16 clusters at most): each block sums its eighth of the
//   buckets over the included rows into its shared memory, every block
//   then copies the others' eighths through distributed shared memory,
//   and streams its columns, out[m] = finish(sign[m] * t[h[m]]), with
//   its first 5 vectors of h and sign loaded before the bucket sums (32
//   sketch rows' loads in flight there). The first version gathered
//   s[k, h[m]] from L2 for every row and column: 35 M scattered reads at
//   60 x 579,402.
// * topk_sum_kernel (mean, dp; topk). Bound: bytes, a few MB a round. The
//   encode sorts each row's pairs by index. A block of 2048 columns finds
//   each included row's window [lo, hi) of its columns by a G-ary search
//   (G lanes a row probe G positions a step, lo and hi at once: 6 steps
//   at k = 5,794 and 60 rows, where one binary search a thread took 2 x
//   13), stages the windows' pairs into shared memory in one parallel
//   pass (at most 2048 pairs and 64 rows a stage: a row's window never
//   holds more than 2048, its indices being distinct), and marks for each
//   thread (8 columns) the rows that reach its columns and where. Each
//   thread then adds its pairs in ascending row order, in registers, with
//   no barrier between rows. The search runs in 32-bit integers: with
//   64-bit divisions this kernel took a third longer. The first version
//   walked the rows one at a time with a global load and a block barrier
//   each.
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTopkCols = 2048;    // columns per block of topk_sum_kernel
constexpr int kTopkOwn = kTopkCols / kThreads;  // ... and per thread
constexpr int kTopkStage = 2048;   // pairs a stage holds: >= kTopkCols, so a
                                   // row's window (distinct indices) fits
constexpr int kTopkStageRows = 64; // rows a stage holds: a bit each in a mask
constexpr int kMaxProbe = 8;       // most lanes a row in topk's G-ary search
constexpr int kSketchCluster = 8;  // blocks a sketch cluster (the portable most)
constexpr int kSketchClusters = 16;  // most clusters: 128 blocks, one an SM
constexpr int kSketchPre = 5;      // column vectors a thread loads ahead
constexpr int kSketchUnroll = 32;  // sketch rows in flight in the bucket sums
constexpr long long kMaxSketchDim = 57344;  // buckets in shared memory (224 KB)
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

// int8 -> f32 without the conversion unit: the bits 0x4B000080 + q are the
// float 2^23 + 128 + q, exact for |q| <= 128, and so is the subtraction
__device__ __forceinline__ float i8_to_f32(int8_t x) {
  return __int_as_float(0x4B000080 + static_cast<int>(x)) - 8388736.0f;
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
// stream_kernel keeps kUnroll rows' loads in flight. Where kRowScale (int8)
// it splits a load in two, so that the raw bytes, not their f32 values,
// wait in registers: fetch (the raw load), decode (to f32, times the row's
// scale sc that stage_rows put in shared memory), and fetch1 for one
// element.

template <typename S, int VW>
struct DecIdentity {
  static constexpr int kVW = VW;
  static constexpr int kUnroll = 4;
  static constexpr bool kFiveBlocks = false;  // stream_kernel, not _5
  static constexpr bool kRowScale = false;
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
  static constexpr int kUnroll = 8;
  static constexpr bool kFiveBlocks = true;   // stream_kernel_5
  static constexpr bool kRowScale = true;
  const int8_t* q;
  long long ld;
  const float* scale;
  struct Col {};
  using Raw = Pack<int8_t, VW>;
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
  __device__ __forceinline__ Raw fetch(int row, long long col) const {
    return load_pack<int8_t, VW>(q + static_cast<long long>(row) * ld + col);
  }
  __device__ __forceinline__ void decode(const Raw& p, float sc, float* v) const {
#pragma unroll
    for (int i = 0; i < VW; ++i) v[i] = i8_to_f32(p.v[i]) * sc;
  }
  __device__ __forceinline__ float fetch1(int row, float sc, long long m) const {
    return i8_to_f32(q[static_cast<long long>(row) * ld + m]) * sc;
  }
};

// CountSketch estimate: the bucket h[m] of the row, times sign[m]
template <int VW>
struct DecSketch {
  static constexpr int kVW = VW;
  static constexpr int kUnroll = 4;
  static constexpr bool kFiveBlocks = false;  // stream_kernel, not _5
  static constexpr bool kRowScale = false;
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
// into s_row with their contraction weight in s_wg (and, where sc is given,
// their scale sc[k] in s_sc), add their gate weight to den (in a fixed
// order, so every block divides by the same value). dp's clip scale is
// read only for included rows: a NaN scale behind a zero gate must not
// leak. Returns the number of rows staged.
template <bool kDP>
__device__ __forceinline__ int stage_rows(int c0, int C, const float* w,
                                          const float* g, const float* rs,
                                          const float* sc, int* s_row,
                                          float* s_wg, float* s_sc,
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
    if (sc != nullptr) s_sc[pos] = sc[k];
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
// rows j .. j + U of the staged rows into acc, every load issued before any
// row is added; kTail predicates the rows past n
template <class Dec, int U, bool kTail>
__device__ __forceinline__ void add_rows(const Dec& dec, const typename Dec::Col& cs,
                                         const int* s_row, const float* s_wg,
                                         const float* s_sc, int j, int n,
                                         long long col, float* acc) {
  constexpr int VW = Dec::kVW;
  if constexpr (Dec::kRowScale) {
    typename Dec::Raw raw[U];
#pragma unroll
    for (int r = 0; r < U; ++r)
      if (!kTail || j + r < n) raw[r] = dec.fetch(s_row[j + r], col);
#pragma unroll
    for (int r = 0; r < U; ++r) {
      if (!kTail || j + r < n) {
        float v[VW];
        dec.decode(raw[r], s_sc[j + r], v);
        const float wr = s_wg[j + r];
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] = fmaf(wr, v[i], acc[i]);
      }
    }
  } else {
    float v[U][VW];
#pragma unroll
    for (int r = 0; r < U; ++r)
      if (!kTail || j + r < n) dec.load(cs, s_row[j + r], col, v[r]);
#pragma unroll
    for (int r = 0; r < U; ++r) {
      if (!kTail || j + r < n) {
        const float wr = s_wg[j + r];
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] = fmaf(wr, v[r][i], acc[i]);
      }
    }
  }
}

template <class Dec, bool kDP, typename O>
__device__ __forceinline__ void stream_body(Dec dec, const float* __restrict__ w,
                                            const float* __restrict__ g,
                                            const float* __restrict__ rs,
                                            const float* __restrict__ noise,
                                            float noise_scale, O* __restrict__ out,
                                            int C, long long M) {
  constexpr int VW = Dec::kVW;
  constexpr int U = Dec::kUnroll;
  __shared__ int s_row[kThreads];
  __shared__ float s_wg[kThreads];
  __shared__ float s_sc[Dec::kRowScale ? kThreads : 1];
  __shared__ int s_warp_n[kWarps];
  __shared__ float s_warp_den[kWarps];
  const float* sc = nullptr;
  if constexpr (Dec::kRowScale) sc = dec.scale;

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
    const int n = stage_rows<kDP>(c0, C, w, g, rs, sc, s_row, s_wg, s_sc,
                                  s_warp_n, s_warp_den, den);
    if (full) {
      // U rows' loads in flight at a time; the rest of a row count that is
      // not a multiple of U one predicated group (int8's 16) or row by row
      int j = 0;
      for (; j + U <= n; j += U)
        add_rows<Dec, U, false>(dec, cs, s_row, s_wg, s_sc, j, n, col, acc);
      if constexpr (Dec::kRowScale) {
        if (j < n) add_rows<Dec, U, true>(dec, cs, s_row, s_wg, s_sc, j, n, col, acc);
      } else {
        for (; j < n; ++j) add_rows<Dec, 1, false>(dec, cs, s_row, s_wg, s_sc, j, n, col, acc);
      }
    } else if (live) {
      for (int j = 0; j < n; ++j) {  // scalar tail for a ragged M
        const float wr = s_wg[j];
        for (int i = 0; i < VW && col + i < M; ++i) {
          float x;
          if constexpr (Dec::kRowScale) x = dec.fetch1(s_row[j], s_sc[j], col + i);
          else x = dec.load1(s_row[j], col + i);
          acc[i] = fmaf(wr, x, acc[i]);
        }
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

#define STREAM_PARAMS                                                         \
  Dec dec, const float* __restrict__ w, const float* __restrict__ g,          \
      const float* __restrict__ rs, const float* __restrict__ noise,          \
      float noise_scale, O* __restrict__ out, int C, long long M

template <class Dec, bool kDP, typename O>
__global__ void __launch_bounds__(kThreads) stream_kernel(STREAM_PARAMS) {
  stream_body<Dec, kDP, O>(dec, w, g, rs, noise, noise_scale, out, C, M);
}

// the same, held to 65536 / (5 x 256) registers (48) so that 5 blocks share
// an SM: int8's 566 blocks at 60 x 579,402 run in one wave
template <class Dec, bool kDP, typename O>
__global__ void __launch_bounds__(kThreads, 5) stream_kernel_5(STREAM_PARAMS) {
  stream_body<Dec, kDP, O>(dec, w, g, rs, noise, noise_scale, out, C, M);
}
#undef STREAM_PARAMS

// ------------------------------------------------------------ sketch kernel
// A thread's column vectors of VW = 4 (16-byte loads of h and sign): the
// v-th of a batch at c + v stride. Columns past M get bucket 0 and sign 0
// and are not stored.
struct SketchCols {
  static constexpr int VW = 4;
  int h[kSketchPre][VW];
  float sg[kSketchPre][VW];

  __device__ __forceinline__ void load(const int* hp, const float* sign,
                                       long long c, long long stride, long long M) {
#pragma unroll
    for (int v = 0; v < kSketchPre; ++v, c += stride) {
      if (c + VW <= M) {
        const Pack<int, VW> ph = load_pack<int, VW>(hp + c);
        const Pack<float, VW> ps = load_pack<float, VW>(sign + c);
#pragma unroll
        for (int i = 0; i < VW; ++i) {
          h[v][i] = ph.v[i];
          sg[v][i] = ps.v[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < VW; ++i) {
          const bool in = c + i < M;
          h[v][i] = in ? hp[c + i] : 0;
          sg[v][i] = in ? sign[c + i] : 0.f;
        }
      }
    }
  }

  // out[m] = finish(sign[m] t[h[m]]); + 0 turns a -0 product into +0, as
  // the decode-first sum (which starts from +0) gives
  template <bool kDP>
  __device__ __forceinline__ void store(const float* t, float den, const float* noise,
                                        float noise_scale, float* out, long long c,
                                        long long stride, long long M) const {
#pragma unroll
    for (int v = 0; v < kSketchPre; ++v, c += stride) {
      if (c >= M) continue;
      float o[VW];
#pragma unroll
      for (int i = 0; i < VW; ++i)
        o[i] = finish<kDP>(sg[v][i] * t[h[v][i]] + 0.f, den, noise, noise_scale,
                           c + i < M ? c + i : c);
      if (c + VW <= M) {
        store_vec<float, VW>(out + c, o);
      } else {
        for (int i = 0; i < VW && c + i < M; ++i) out[c + i] = o[i];
      }
    }
  }
};

// the two halves of a cluster barrier, so that a block can stream its
// columns between them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");  // release
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");  // acquire
}

template <bool kDP>
__global__ void __launch_bounds__(kThreads)
    sketch_kernel(const float* __restrict__ s, long long dim,
                  const int* __restrict__ h, const float* __restrict__ sign,
                  const float* __restrict__ w, const float* __restrict__ g,
                  const float* __restrict__ rs, const float* __restrict__ noise,
                  float noise_scale, float* __restrict__ out, int C, long long M) {
  extern __shared__ float t[];  // [dim] bucket sums
  __shared__ int s_row[kThreads];
  __shared__ float s_wg[kThreads];
  __shared__ int s_warp_n[kWarps];
  __shared__ float s_warp_den[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const long long per = (dim + kSketchCluster - 1) / kSketchCluster;
  const long long b0 = rank * per;
  const long long b1 = b0 + per < dim ? b0 + per : dim;
  constexpr int VW = SketchCols::VW;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * VW;
  const long long col0 = (static_cast<long long>(blockIdx.x) * kThreads + tid) * VW;

  SketchCols cols;  // the first batch is in flight during the bucket sums
  cols.load(h, sign, col0, stride, M);

  // 1. t[b] for this block's buckets, over the included rows in ascending
  //    order (the decode-first sum's order)
  for (long long b = b0 + tid; b < b1; b += kThreads) t[b] = 0.f;
  float den = 0.f;
  for (int c0 = 0; c0 < C; c0 += kThreads) {
    const int n = stage_rows<kDP>(c0, C, w, g, rs, nullptr, s_row, s_wg, nullptr,
                                  s_warp_n, s_warp_den, den);
    for (long long b = b0 + tid; b < b1; b += kThreads) {
      float acc = t[b];
      for (int j = 0; j < n; j += kSketchUnroll) {
        float v[kSketchUnroll];
#pragma unroll
        for (int r = 0; r < kSketchUnroll; ++r)
          if (j + r < n) v[r] = s[static_cast<long long>(s_row[j + r]) * dim + b];
#pragma unroll
        for (int r = 0; r < kSketchUnroll; ++r)
          if (j + r < n) acc = fmaf(s_wg[j + r], v[r], acc);
      }
      t[b] = acc;
    }
    __syncthreads();  // the next chunk overwrites s_row / s_wg
  }

  // 2. the other blocks' buckets, through distributed shared memory
  cluster.sync();
  for (long long i = tid; i < per; i += kThreads) {
    float v[kSketchCluster];
#pragma unroll
    for (int r = 0; r < kSketchCluster; ++r) {
      const long long b = r * per + i;
      if (r != rank && b < dim) v[r] = cluster.map_shared_rank(t, r)[b];
    }
#pragma unroll
    for (int r = 0; r < kSketchCluster; ++r) {
      const long long b = r * per + i;
      if (r != rank && b < dim) t[b] = v[r];
    }
  }
  __syncthreads();
  cluster_arrive();  // this block reads no other block's t from here on

  // 3. the columns, kSketchPre vectors a batch
  for (long long c = col0;; c += kSketchPre * stride) {
    cols.template store<kDP>(t, den, noise, noise_scale, out, c, stride, M);
    if (c + kSketchPre * stride >= M) break;
    cols.load(h, sign, c + kSketchPre * stride, stride, M);
  }
  cluster_wait();  // no block leaves while another reads its t
}

// ------------------------------------------------------------ topk sum kernel
// Shared memory of topk_sum_kernel (dynamic, ~56 KB)
struct TopkSmem {
  int idx[kTopkStage];                             // the stage's pairs, row by row
  float val[kTopkStage];
  unsigned short first[kTopkStageRows][kThreads];  // (row, owner): its first pair
  unsigned long long mask[kThreads];               // owner: the rows that reach it
  int lo[kThreads];                                // row: its window's start
  int off[kThreads + 1];                           // row: its window's offset in
                                                   // the chunk's windows
  unsigned char rowof[kTopkStage];                 // pair: its row in the stage
};

// The G-ary search for the first position of an ascending row whose value
// is >= a key: the answer lies in [a, b]; with s = ceil((b - a) / (G + 1)),
// lane i < G probes probe(a, b, s, i) = min(a + (i + 1) s - 1, b - 1), and
// each step leaves at most s - 1 candidates. 32-bit: a 64-bit division is a
// long software sequence, and positions stay below k <= M < 2^31.
__device__ __forceinline__ int probe(int a, int b, int s, int i) {
  const int q = a + (i + 1) * s - 1;
  return q < b - 1 ? q : b - 1;
}

// a step: t of the G probes lie below the key
__device__ __forceinline__ void narrow(int& a, int& b, int s, int t, int G) {
  if (a >= b) return;
  if (t == 0) {                       // row[probe 0] >= key
    b = probe(a, b, s, 0);
    return;
  }
  const int na = probe(a, b, s, t - 1) + 1;
  if (t < G) b = probe(a, b, s, t);   // row[probe t] >= key
  a = na;
}

// each of the n staged rows' window [lo, hi) of the columns [c0, c1): lo in
// s_lo, its offset in the concatenation of the windows in s_off (s_off[n]
// the total). G lanes a row (as many as fit, at most kMaxProbe) search lo
// and hi at once, G probes each a step.
__device__ __forceinline__ void find_windows(const DecTopk& dec, int n, int c0, int c1,
                                             const int* s_row, int* s_lo, int* s_off) {
  const int tid = threadIdx.x, lane = tid & 31;
  int G = 1;
  while (G < kMaxProbe && 2 * G * n <= kThreads) G <<= 1;
  const int gl = tid & (G - 1);
  const unsigned gmask = ((1u << G) - 1u) << (lane & ~(G - 1));
  for (int j0 = 0; j0 < n; j0 += kThreads / G) {
    const int j = j0 + tid / G;
    const bool on = j < n;
    const int* row = dec.idx + (on ? static_cast<long long>(s_row[j]) * dec.k : 0);
    int alo = 0, blo = on ? static_cast<int>(dec.k) : 0, ahi = 0, bhi = blo;
    while (__any_sync(0xffffffffu, alo < blo || ahi < bhi)) {
      const int slo = (blo - alo + G) / (G + 1), shi = (bhi - ahi + G) / (G + 1);
      const bool plo = alo < blo && row[probe(alo, blo, slo, gl)] < c0;
      const bool phi = ahi < bhi && row[probe(ahi, bhi, shi, gl)] < c1;
      const int tlo = __popc(__ballot_sync(0xffffffffu, plo) & gmask);
      const int thi = __popc(__ballot_sync(0xffffffffu, phi) & gmask);
      narrow(alo, blo, slo, tlo, G);
      narrow(ahi, bhi, shi, thi, G);
    }
    if (on && gl == 0) {
      s_lo[j] = alo;
      // at most c1 - c0 <= kTopkStage pairs, the indices being distinct; the
      // clamp only keeps a row that breaks this inside the stage
      const int wdt = ahi - alo;
      s_off[j + 1] = wdt < kTopkStage ? wdt : kTopkStage;
    }
  }
  __syncthreads();
  if (tid < 32) {  // inclusive scan of the widths
    int carry = 0;
    for (int b = 0; b < n; b += 32) {
      int v = b + lane < n ? s_off[b + lane + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
      }
      if (b + lane < n) s_off[b + lane + 1] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) s_off[0] = 0;
  }
  __syncthreads();
}

template <bool kDP>
__global__ void __launch_bounds__(kThreads)
    topk_sum_kernel(DecTopk dec, const float* __restrict__ w,
                    const float* __restrict__ g, const float* __restrict__ rs,
                    const float* __restrict__ noise, float noise_scale,
                    float* __restrict__ out, int C, long long M) {
  extern __shared__ __align__(16) unsigned char topk_smem[];
  TopkSmem& sm = *reinterpret_cast<TopkSmem*>(topk_smem);
  __shared__ int s_row[kThreads];
  __shared__ float s_wg[kThreads];
  __shared__ int s_warp_n[kWarps];
  __shared__ float s_warp_den[kWarps];
  constexpr int kPer = kTopkStage / kThreads;  // pairs a thread stages

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long c0 = static_cast<long long>(blockIdx.x) * kTopkCols;
  const long long c1 = c0 + kTopkCols < M ? c0 + kTopkCols : M;
  const long long mine = c0 + static_cast<long long>(tid) * kTopkOwn;  // its columns
  float acc[kTopkOwn];
#pragma unroll
  for (int i = 0; i < kTopkOwn; ++i) acc[i] = 0.f;
  sm.mask[tid] = 0ull;
  float den = 0.f;

  for (int r0 = 0; r0 < C; r0 += kThreads) {
    const int n = stage_rows<kDP>(r0, C, w, g, rs, nullptr, s_row, s_wg, nullptr,
                                  s_warp_n, s_warp_den, den);
    find_windows(dec, n, static_cast<int>(c0), static_cast<int>(c1), s_row, sm.lo,
                 sm.off);
    for (int jr = 0; jr < n;) {
      // the stage: rows [jr, je), at most kTopkStageRows rows and kTopkStage
      // pairs (one row alone always fits)
      int je = jr + 1;
      {
        int hi = n < jr + kTopkStageRows ? n : jr + kTopkStageRows;
        const int lim = sm.off[jr] + kTopkStage;
        while (je < hi) {
          const int mid = (je + hi + 1) >> 1;
          if (sm.off[mid] <= lim) je = mid; else hi = mid - 1;
        }
      }
      const int base = sm.off[jr], cnt = sm.off[je] - base;
      for (int j = jr + warp; j < je; j += kWarps)
        for (int i = sm.off[j] - base + lane; i < sm.off[j + 1] - base; i += 32)
          sm.rowof[i] = static_cast<unsigned char>(j - jr);
      __syncthreads();
      int qi[kPer];  // every pair's loads issued before any is stored
      float qv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int q = tid + i * kThreads;
        if (q < cnt) {
          const int j = jr + sm.rowof[q];
          const long long p = static_cast<long long>(s_row[j]) * dec.k + sm.lo[j] +
                              (q - (sm.off[j] - base));
          qi[i] = dec.idx[p];
          qv[i] = dec.vals[p];
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int q = tid + i * kThreads;
        if (q < cnt) {
          sm.idx[q] = qi[i];
          sm.val[q] = qv[i];
        }
      }
      __syncthreads();
      // the first pair of each (row, owner thread): where it is, and the
      // row's bit in the owner's mask
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int q = tid + i * kThreads;
        if (q < cnt) {
          const int jj = sm.rowof[q];
          const int o = static_cast<int>(qi[i] - c0) / kTopkOwn;
          if (q == 0 || sm.rowof[q - 1] != jj ||
              static_cast<int>(sm.idx[q - 1] - c0) / kTopkOwn != o) {
            sm.first[jj][o] = static_cast<unsigned short>(q);
            atomicOr(&sm.mask[o], 1ull << jj);
          }
        }
      }
      __syncthreads();
      // this thread's pairs, in ascending row order; rows add into a column
      // only through its owner, so no barrier stands between rows
      unsigned long long m = sm.mask[tid];
      sm.mask[tid] = 0ull;
      while (m) {
        const int jj = __ffsll(static_cast<long long>(m)) - 1;
        m &= m - 1;
        const float wr = s_wg[jr + jj];
        const int end = sm.off[jr + jj + 1] - base;
        for (int p = sm.first[jj][tid]; p < end; ++p) {
          const int c = static_cast<int>(sm.idx[p] - mine);  // in [0, 2048)
          if (c >= kTopkOwn) break;
          const float v = sm.val[p];
#pragma unroll
          for (int i = 0; i < kTopkOwn; ++i) acc[i] = c == i ? fmaf(wr, v, acc[i]) : acc[i];
        }
      }
      __syncthreads();  // the next stage (or row chunk) overwrites the stage
      jr = je;
    }
  }
  float* s_acc = reinterpret_cast<float*>(sm.idx);  // the stage is free now
#pragma unroll
  for (int i = 0; i < kTopkOwn; ++i) s_acc[tid * kTopkOwn + i] = acc[i];
  __syncthreads();
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
  const unsigned grid = static_cast<unsigned>(blocks);
  auto* out = static_cast<O*>(a.out);
  if constexpr (Dec::kFiveBlocks)
    stream_kernel_5<Dec, kDP, O><<<grid, kThreads, 0, s>>>(
        dec, a.w, a.g, a.row_scale, a.noise, a.noise_scale, out, a.C, a.M);
  else
    stream_kernel<Dec, kDP, O><<<grid, kThreads, 0, s>>>(
        dec, a.w, a.g, a.row_scale, a.noise, a.noise_scale, out, a.C, a.M);
  return cudaGetLastError();
}

// raise a kernel's dynamic shared memory limit, once per instantiation
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) *done = true;
  return e;
}

template <bool kDP>
cudaError_t launch_sketch(const FedaggArgs& a, cudaStream_t s) {
  static bool attr_set = false;
  const cudaError_t e = allow_smem(sketch_kernel<kDP>,
                                   kMaxSketchDim * sizeof(float), &attr_set);
  if (e != cudaSuccess) return e;
  const long long per_cluster =
      static_cast<long long>(kSketchCluster) * kThreads * SketchCols::VW;
  long long clusters = (a.M + per_cluster - 1) / per_cluster;
  clusters = clusters < kSketchClusters ? clusters : kSketchClusters;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kSketchCluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(a.ld) * sizeof(float);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSketchCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, sketch_kernel<kDP>, static_cast<const float*>(a.u), a.ld,
      a.sketch_h, a.sketch_sign, a.w, a.g, a.row_scale, a.noise, a.noise_scale,
      static_cast<float*>(a.out), a.C, a.M);
  if (err != cudaSuccess) return err;
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
        case 4: return launch_stream<DecInt8<4>, kDP, float>(a, {q, a.ld, a.dequant_scale}, s);
        case 1: return launch_stream<DecInt8<1>, kDP, float>(a, {q, a.ld, a.dequant_scale}, s);
      }
      break;
    }
    case kSketch: {
      // the buckets fit shared memory, h / sign / out take 16-byte loads
      if (a.ld >= 1 && a.ld <= kMaxSketchDim && a.vw == SketchCols::VW)
        return launch_sketch<kDP>(a, s);
      const auto* sk = static_cast<const float*>(a.u);  // else gather from L2
      switch (a.vw) {
        case 4: return launch_stream<DecSketch<4>, kDP, float>(a, {sk, a.ld, a.sketch_h, a.sketch_sign}, s);
        case 1: return launch_stream<DecSketch<1>, kDP, float>(a, {sk, a.ld, a.sketch_h, a.sketch_sign}, s);
      }
      break;
    }
    case kTopk: {
      const long long blocks = (a.M + kTopkCols - 1) / kTopkCols;
      if (blocks > INT_MAX) return cudaErrorInvalidValue;
      static bool attr_set = false;
      const cudaError_t e = allow_smem(topk_sum_kernel<kDP>, sizeof(TopkSmem), &attr_set);
      if (e != cudaSuccess) return e;
      const DecTopk dec{static_cast<const float*>(a.u), a.topk_idx, a.ld};
      topk_sum_kernel<kDP><<<static_cast<unsigned>(blocks), kThreads, sizeof(TopkSmem), s>>>(
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
  static bool attr_set = false;
  const cudaError_t e =
      allow_smem(sorted_kernel<Dec, kMedian, O>, kMaxSmem - kMaxSortRows, &attr_set);
  if (e != cudaSuccess) return e;
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
