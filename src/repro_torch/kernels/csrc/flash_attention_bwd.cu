// Flash-attention backward for NVIDIA Hopper (sm_90a): dq, dk and dv of
// causal or windowed grouped-query attention, from the forward's inputs,
// its output and per-row log-sum-exp, and dO.
//
//   q, out, dO [B, Sq, H, hd], k, v [B, Skv, KV, hd] (f32 or bf16, all one
//   dtype); query head h reads kv head h / G (G = H / KV); query i sits at
//   absolute position q_pos = q_offset + i (0 <= q_offset <= Skv - Sq; a
//   key no query sees gets dk = dv = 0); key j is visible where
//   j < Skv, and j <= q_pos if causal, and j > q_pos - window if window > 0;
//   lse [B * KV, G, Sq] f32 (the forward kernel's, i.e. [B, H, Sq]);
//   delta [B, H, Sq] f32 scratch = rowsum(dO * O), written by the dq pass;
//   p = exp(q k^T scale - lse) on visible pairs, 0 elsewhere;
//   ds = p (dO v^T - delta);
//   dq = ds k scale, dk = ds^T (q scale), dv = p^T dO, each rounded once to
//   the primal dtype; dk and dv summed over the G query heads of a kv head.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_bwd_pallas: _kernel_dq (a grid over (kv head, group,
// q block, kv block) accumulating dq in VMEM scratch) and _kernel_dkv (kv
// block outer, q block inner), which the reference calls once per query
// group g and adds up (G calls, G - 1 adds), and delta from jnp.
//
// Two passes, one launch each on one stream, no atomics (deterministic);
// two routes by dtype (not a fallback: a launch that fails returns its
// error):
//
// * bf16 inputs: the tensor-core kernels (namespace tc, below), the
//   forward's tiles (csrc/hopper_tc.cuh): every product on bf16 wgmma with
//   f32 accumulation, tiles loaded by TMA into a 2-stage ring by the lane 0
//   of a producer warp, one consumer warpgroup a block. s and dP (or s^T,
//   dP^T) are products of bf16 operands, exact in f32 up to summation
//   order; p and ds are f32 and split into bf16 hi + lo, each product that
//   takes them issued twice into one f32 sum (the reference's parity bound
//   holds; a single bf16 p or ds leaves it: tests/
//   test_torch_flash_tc_numerics.py). scale is applied to the f32 scores
//   and, at the end, to dq and dk.
//   - dq: a block owns 64 query rows of one (batch, head); a prologue
//     computes delta = rowsum(dO O) from the rounded output for them
//     (stored for the dk/dv pass); per 64-key tile s = q k^T and
//     dP = dO v^T (wgmma SS), p, ds on the accumulator fragments, dq +=
//     ds_hi k + ds_lo k (wgmma RS, k read MN-major).
//   - dk/dv: a block owns 64 key rows of one (batch, kv head) with the keys
//     as the M dimension; it walks the G query heads and, for each, only
//     the query tiles (64 rows at hd <= 64, else 32) that see one of its
//     keys: s^T = k q^T, dP^T = v dO^T, p^T, ds^T, dv += p^T_hi dO +
//     p^T_lo dO, dk += ds^T_hi q + ds^T_lo q; the sum over the group stays
//     in f32 registers and is rounded once. Blocks run heaviest first
//     (the last query rows for dq, the first keys for dk/dv).
//   Bound: bytes at qwen1.5-0.5b's training shape, operations at
//   qwen2.5-3b's; the split makes 10 product units of the pair's usual 8
//   (s, dP, dv 2, dk 2, and s, dP, dq 2 with dq in its own pass).
// * f32 inputs: the CUDA-core kernels below, f32 math as the reference:
//   q * scale rounded in f32 before the products, f32 scores, p, ds and
//   sums, one rounding out. dq: a block owns 32 query rows of one (batch,
//   head), 4 threads a row, each holding an interleaved quarter of q
//   (scaled), dO and the dq accumulator in registers (float4 chunks at
//   columns 16 i + 4 p); a prologue computes the row's delta; the block
//   walks 32-key tiles of k and v staged as f32 in padded shared memory;
//   per key the row's 4 threads reduce s = q k and dP = dO v with
//   xor-shuffles. dk/dv: a block owns 32 key rows of one (batch, kv head),
//   walks all G query heads and, for each, only the query rows that can
//   see one of its keys, staging 32 rows of q * scale and dO, and their
//   lse and delta, per tile in shared memory.
//
// C interface (bound with ctypes): flash_attention_bwd_launch() returns the
// first launch error (cudaError_t); flash_attention_bwd_error_string()
// names it.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = kThreads / 4;  // query rows (dq) or key rows (dk/dv) per block
constexpr int kTile = 32;            // keys (dq) or queries (dk/dv) per staged tile
constexpr int kPad = 16;             // floats of padding per shared row

__device__ __forceinline__ void load_f32x8(const float* p, float* d) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, d_sb, d_ss;  // batch / seq strides
  int B, Sq, Skv, H, KV, causal, window, q_offset;
  float scale;
};

// Stage rows [t0, t0 + kTile) of one head (base points at row 0 of it) into
// shared memory as f32 times mul (rounded in f32); rows at or past limit
// are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float (*dst)[HD + kPad], const T* base,
                                          long long ss, int t0, int limit, float mul) {
  constexpr int kChunks = HD / 8;              // 8 values a load
  for (int idx = static_cast<int>(threadIdx.x); idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    float vals[8];
    if (t0 + r < limit) {
      load_f32x8(base + (t0 + r) * ss + c, vals);
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] *= mul;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = 0.0f;
    }
    *reinterpret_cast<float4*>(&dst[r][c]) = make_float4(vals[0], vals[1], vals[2], vals[3]);
    *reinterpret_cast<float4*>(&dst[r][c + 4]) = make_float4(vals[4], vals[5], vals[6], vals[7]);
  }
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ bool visible(int kp, int q_pos, int Skv, int causal, int window) {
  return kp < Skv && (!causal || kp <= q_pos) && (window <= 0 || kp > q_pos - window);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Args a) {
  constexpr int kQ = HD / 16;                  // float4 chunks per thread
  __shared__ __align__(16) float ks[kTile][HD + kPad];
  __shared__ __align__(16) float vs[kTile][HD + kPad];

  const int bh = static_cast<int>(blockIdx.y);
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int part = static_cast<int>(threadIdx.x) & 3;
  const int row0 = static_cast<int>(blockIdx.x) * kRows;
  const int row = row0 + (static_cast<int>(threadIdx.x) >> 2);
  const bool active = row < a.Sq;
  const int qrow = active ? row : a.Sq - 1;
  const int q_offset = a.q_offset;
  const int q_pos = q_offset + qrow;

  // this thread's quarter of q (scaled, rounded in f32), dO and dq; delta
  const long long hoff = static_cast<long long>(h) * HD;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + qrow * a.q_ss + hoff;
  const T* op = static_cast<const T*>(a.out) + b * a.o_sb + qrow * a.o_ss + hoff;
  const T* dp = static_cast<const T*>(a.dout) + b * a.d_sb + qrow * a.d_ss + hoff;
  float qr[kQ][4], dor[kQ][4], acc[kQ][4];
  float dsum = 0.0f;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 16 * i + 4 * part + e;
      qr[i][e] = to_f(qp[c]) * a.scale;
      dor[i][e] = to_f(dp[c]);
      dsum = fmaf(dor[i][e], to_f(op[c]), dsum);
      acc[i][e] = 0.0f;
    }
  }
  const float delta = row_sum(dsum);
  const long long rid = (static_cast<long long>(b) * a.H + h) * a.Sq + qrow;
  const float lse = a.lse[rid];
  if (active && part == 0) a.delta[rid] = delta;

  // the block's rows cover positions [first, last]; skip tiles none sees
  const int first = q_offset + row0;
  const int last = q_offset + min(a.Sq - 1, row0 + kRows - 1);
  int lo = 0, hi = a.Skv;
  if (a.causal) hi = min(hi, last + 1);
  if (a.window > 0) lo = max(0, first - a.window + 1);
  lo = (lo / kTile) * kTile;

  const long long kvoff = static_cast<long long>(kvh) * HD;
  const T* kbase = static_cast<const T*>(a.k) + b * a.k_sb + kvoff;
  const T* vbase = static_cast<const T*>(a.v) + b * a.v_sb + kvoff;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    __syncthreads();                           // the previous tile is consumed
    load_tile<T, HD>(ks, kbase, a.k_ss, t0, a.Skv, 1.0f);
    load_tile<T, HD>(vs, vbase, a.v_ss, t0, a.Skv, 1.0f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float s = 0.0f, dpv = 0.0f;
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[j][16 * i + 4 * part]);
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][16 * i + 4 * part]);
        s = fmaf(qr[i][0], kv.x, s);
        s = fmaf(qr[i][1], kv.y, s);
        s = fmaf(qr[i][2], kv.z, s);
        s = fmaf(qr[i][3], kv.w, s);
        dpv = fmaf(dor[i][0], vv.x, dpv);
        dpv = fmaf(dor[i][1], vv.y, dpv);
        dpv = fmaf(dor[i][2], vv.z, dpv);
        dpv = fmaf(dor[i][3], vv.w, dpv);
      }
      s = row_sum(s);
      dpv = row_sum(dpv);
      const float p = visible(t0 + j, q_pos, a.Skv, a.causal, a.window) ? expf(s - lse) : 0.0f;
      const float ds = p * (dpv - delta);
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[j][16 * i + 4 * part]);
        acc[i][0] = fmaf(ds, kv.x, acc[i][0]);
        acc[i][1] = fmaf(ds, kv.y, acc[i][1]);
        acc[i][2] = fmaf(ds, kv.z, acc[i][2]);
        acc[i][3] = fmaf(ds, kv.w, acc[i][3]);
      }
    }
  }

  if (!active) return;
  T* out = static_cast<T*>(a.dq) + ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * HD;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[16 * i + 4 * part + e] = from_f<T>(acc[i][e] * a.scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Args a) {
  constexpr int kQ = HD / 16;
  __shared__ __align__(16) float qs[kTile][HD + kPad];   // q * scale
  __shared__ __align__(16) float dos[kTile][HD + kPad];  // dO
  __shared__ float ls[kTile];
  __shared__ float dl[kTile];

  const int bk = static_cast<int>(blockIdx.y);
  const int b = bk / a.KV;
  const int kvh = bk % a.KV;
  const int G = a.H / a.KV;
  const int part = static_cast<int>(threadIdx.x) & 3;
  const int key0 = static_cast<int>(blockIdx.x) * kRows;
  const int key = key0 + (static_cast<int>(threadIdx.x) >> 2);
  const bool active = key < a.Skv;
  const int krow = active ? key : a.Skv - 1;
  const int q_offset = a.q_offset;

  const long long kvoff = static_cast<long long>(kvh) * HD;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + krow * a.k_ss + kvoff;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + krow * a.v_ss + kvoff;
  float kr[kQ][4], vr[kQ][4], dk[kQ][4], dv[kQ][4];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 16 * i + 4 * part + e;
      kr[i][e] = to_f(kp[c]);
      vr[i][e] = to_f(vp[c]);
      dk[i][e] = 0.0f;
      dv[i][e] = 0.0f;
    }
  }

  // query rows i whose position q_offset + i sees a key in [key0, klast]
  const int klast = min(a.Skv - 1, key0 + kRows - 1);
  int lo = 0, hi = a.Sq;
  if (a.causal) lo = max(0, key0 - q_offset);
  if (a.window > 0) hi = min(hi, klast + a.window - q_offset);

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long hoff = static_cast<long long>(h) * HD;
    const T* qbase = static_cast<const T*>(a.q) + b * a.q_sb + hoff;
    const T* dbase = static_cast<const T*>(a.dout) + b * a.d_sb + hoff;
    const long long rbase = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int t0 = lo; t0 < hi; t0 += kTile) {
      __syncthreads();                         // the previous tile is consumed
      load_tile<T, HD>(qs, qbase, a.q_ss, t0, a.Sq, a.scale);
      load_tile<T, HD>(dos, dbase, a.d_ss, t0, a.Sq, 1.0f);
      const int t = static_cast<int>(threadIdx.x);
      if (t < kTile) {
        ls[t] = t0 + t < a.Sq ? a.lse[rbase + t0 + t] : 0.0f;
        dl[t] = t0 + t < a.Sq ? a.delta[rbase + t0 + t] : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float s = 0.0f, dpv = 0.0f;
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(&qs[r][16 * i + 4 * part]);
          const float4 dov = *reinterpret_cast<const float4*>(&dos[r][16 * i + 4 * part]);
          s = fmaf(kr[i][0], qv.x, s);
          s = fmaf(kr[i][1], qv.y, s);
          s = fmaf(kr[i][2], qv.z, s);
          s = fmaf(kr[i][3], qv.w, s);
          dpv = fmaf(vr[i][0], dov.x, dpv);
          dpv = fmaf(vr[i][1], dov.y, dpv);
          dpv = fmaf(vr[i][2], dov.z, dpv);
          dpv = fmaf(vr[i][3], dov.w, dpv);
        }
        s = row_sum(s);
        dpv = row_sum(dpv);
        const int qi = t0 + r;
        const bool ok = active && qi < a.Sq && visible(key, q_offset + qi, a.Skv, a.causal, a.window);
        const float p = ok ? expf(s - ls[r]) : 0.0f;
        const float ds = p * (dpv - dl[r]);
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(&qs[r][16 * i + 4 * part]);
          const float4 dov = *reinterpret_cast<const float4*>(&dos[r][16 * i + 4 * part]);
          dv[i][0] = fmaf(p, dov.x, dv[i][0]);
          dv[i][1] = fmaf(p, dov.y, dv[i][1]);
          dv[i][2] = fmaf(p, dov.z, dv[i][2]);
          dv[i][3] = fmaf(p, dov.w, dv[i][3]);
          dk[i][0] = fmaf(ds, qv.x, dk[i][0]);
          dk[i][1] = fmaf(ds, qv.y, dk[i][1]);
          dk[i][2] = fmaf(ds, qv.z, dk[i][2]);
          dk[i][3] = fmaf(ds, qv.w, dk[i][3]);
        }
      }
    }
  }

  if (!active) return;
  const long long o = ((static_cast<long long>(b) * a.Skv + key) * a.KV + kvh) * HD;
  T* dkp = static_cast<T*>(a.dk) + o;
  T* dvp = static_cast<T*>(a.dv) + o;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dkp[16 * i + 4 * part + e] = from_f<T>(dk[i][e]);
      dvp[16 * i + 4 * part + e] = from_f<T>(dv[i][e]);
    }
  }
}

// ------------------------------------------------------- bf16: tensor cores
namespace tc {

using namespace hopper_tc;

constexpr int kRows = 64;             // query rows (dq) or key rows (dk/dv) a block
constexpr int kThreads = 128 + 32;    // one consumer warpgroup, one producer warp
constexpr int kStages = 2;

template <int HD>
struct Bwd {
  static constexpr int kBc = 64;                    // keys a tile (dq pass)
  static constexpr int kBq = HD <= 64 ? 64 : 32;    // query rows a tile (dk/dv pass)
  static constexpr int kRowTile = kRows * HD * 2;   // a [64][HD] tile
  static constexpr int kQTile = kBq * HD * 2;
  static constexpr int kDqBar = 2 * kRowTile + kStages * 2 * kRowTile;
  static constexpr int kDqSmem = kDqBar + 64 + kRows * 4 + 1024;  // + barriers, delta, alignment
  static constexpr int kDkvBar = 2 * kRowTile + kStages * 2 * kQTile;
  static constexpr int kDkvSmem = kDkvBar + 64 + 1024;
};

__device__ __forceinline__ bool sees(int key, int q_pos, const Args& a) {
  return key < a.Skv && (!a.causal || key <= q_pos) && (a.window <= 0 || key > q_pos - a.window);
}

// Rows [row0, row0 + 64) of query head h: delta = rowsum(dO * O) from the
// rounded output, p = exp(s - lse), ds = p (dP - delta), dq = ds k scale.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mdo,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv, Args a) {
  using W = Bwd<HD>;
  constexpr int kBc = W::kBc;
  uint8_t* smem = smem_1024();
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + W::kRowTile;
  uint8_t* kv_s = smem + 2 * W::kRowTile;           // stage s: k, then v
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + W::kDqBar);
  uint64_t* qd_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;
  float* delta_s = reinterpret_cast<float*>(smem + W::kDqBar + 64);

  const int bh = static_cast<int>(blockIdx.x);
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int row0 = (static_cast<int>(gridDim.y - 1 - blockIdx.y)) * kRows;  // heaviest first
  const int q_offset = a.q_offset;
  const int first = q_offset + row0;
  const int last = q_offset + min(a.Sq - 1, row0 + kRows - 1);
  int lo = 0, hi = a.Skv;
  if (a.causal) hi = min(hi, last + 1);
  if (a.window > 0) lo = max(0, first - a.window + 1);
  lo = (lo / kBc) * kBc;
  const int ntiles = (hi - lo + kBc - 1) / kBc;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {                         // the producer warp
    if (threadIdx.x == 128) {
      mbar_expect_tx(qd_full, 2 * W::kRowTile);
      tma_load_tile<HD>(q_s, &mq, qd_full, kRows, h, row0, b);
      tma_load_tile<HD>(do_s, &mdo, qd_full, kRows, h, row0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * W::kRowTile);
        uint8_t* ks = kv_s + s * 2 * W::kRowTile;
        tma_load_tile<HD>(ks, &mk, &full[s], kBc, kvh, lo + it * kBc, b);
        tma_load_tile<HD>(ks + W::kRowTile, &mv, &full[s], kBc, kvh, lo + it * kBc, b);
      }
    }
    return;
  }

  const int t = static_cast<int>(threadIdx.x);
  const int lane = t % 32;
  const int c = lane % 4;
  const int r = 16 * (t / 32) + lane / 4;
  const long long rbase = (static_cast<long long>(b) * a.H + h) * a.Sq;

  {  // delta of row t / 2 from two threads, each over half of hd
    const int row = row0 + t / 2;
    float dsum = 0.0f;
    if (row < a.Sq) {
      const long long col = static_cast<long long>(h) * HD + (t % 2) * (HD / 2);
      const __nv_bfloat16* op = static_cast<const __nv_bfloat16*>(a.out) + b * a.o_sb + row * a.o_ss + col;
      const __nv_bfloat16* dp = static_cast<const __nv_bfloat16*>(a.dout) + b * a.d_sb + row * a.d_ss + col;
#pragma unroll
      for (int i = 0; i < HD / 2; i += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(op + i);
        const uint4 dv = *reinterpret_cast<const uint4*>(dp + i);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          dsum = fmaf(df.x, of.x, dsum);
          dsum = fmaf(df.y, of.y, dsum);
        }
      }
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    if (t % 2 == 0) {
      delta_s[t / 2] = dsum;
      if (row < a.Sq) a.delta[rbase + row] = dsum;
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");   // the consumer warpgroup
  }
  float dl[2], ls[2];
  bool valid[2];
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + r + 8 * hh;
    valid[hh] = row < a.Sq;
    dl[hh] = delta_s[r + 8 * hh];
    ls[hh] = valid[hh] ? a.lse[rbase + row] : 0.0f;
    qpos[hh] = q_offset + row;
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  const uint32_t q_addr = smem_u32(q_s);
  const uint32_t do_addr = smem_u32(do_s);
  mbar_wait(qd_full, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    const int t0 = lo + it * kBc;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t k_addr = smem_u32(kv_s + s * 2 * W::kRowTile);
    const uint32_t v_addr = k_addr + W::kRowTile;
    float sc[kBc / 2], dp[kBc / 2];
#pragma unroll
    for (int i = 0; i < kBc / 2; ++i) sc[i] = dp[i] = 0.0f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<kBc, 0>(sc, desc_k_major<HD>(q_addr, kRows, 0, kk),
                       desc_k_major<HD>(k_addr, kBc, 0, kk), 1);
      wgmma_ss<kBc, 0>(dp, desc_k_major<HD>(do_addr, kRows, 0, kk),
                       desc_k_major<HD>(v_addr, kBc, 0, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool partial = t0 + kBc > a.Skv || row0 + kRows > a.Sq
                         || (a.causal && t0 + kBc - 1 > first)
                         || (a.window > 0 && t0 <= last - a.window);
#pragma unroll
    for (int j = 0; j < kBc / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int key = t0 + 8 * j + 2 * c + (e & 1);
        const bool ok = !partial || (valid[hh] && sees(key, qpos[hh], a));
        const float p = ok ? expf(sc[4 * j + e] * a.scale - ls[hh]) : 0.0f;
        sc[4 * j + e] = p * (dp[4 * j + e] - dl[hh]);   // ds
      }
    }
    uint32_t dh[kBc / 16][4], dlo[kBc / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) split_a(sc, kk, dh[kk], dlo[kk]);
    fence_regs(acc);
    fence_regs(dh);
    fence_regs(dlo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      const uint64_t dkd = desc_mn_major<HD>(k_addr, kBc, kk);
      wgmma_rs<HD, 1>(acc, dh[kk], dkd, 1);
      wgmma_rs<HD, 1>(acc, dlo[kk], dkd, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!valid[hh]) continue;
    const int row = row0 + r + 8 * hh;
    __nv_bfloat16* op = dq + ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * HD + 2 * c;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * hh] * a.scale, acc[4 * j + 2 * hh + 1] * a.scale);
    }
  }
}

// Key rows [key0, key0 + 64) of kv head kvh: for each of its G query heads
// and each query tile that sees a key of the block, s^T = k q^T and
// dP^T = v dO^T, p^T = exp(s^T - lse), ds^T = p^T (dP^T - delta);
// dv += p^T dO, dk += ds^T q (scale at the end), summed over the group in
// f32 registers and rounded once.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mdo,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv, Args a) {
  using W = Bwd<HD>;
  constexpr int kBq = W::kBq;
  uint8_t* smem = smem_1024();
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + W::kRowTile;
  uint8_t* qd_s = smem + 2 * W::kRowTile;           // stage s: q, then dO
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + W::kDkvBar);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bk = static_cast<int>(blockIdx.x);
  const int b = bk / a.KV;
  const int kvh = bk % a.KV;
  const int G = a.H / a.KV;
  const int key0 = static_cast<int>(blockIdx.y) * kRows;  // early keys (heaviest) first
  const int q_offset = a.q_offset;

  // query rows i whose position q_offset + i sees a key in [key0, klast]
  const int klast = min(a.Skv - 1, key0 + kRows - 1);
  int lo = 0, hi = a.Sq;
  if (a.causal) lo = max(0, key0 - q_offset);
  if (a.window > 0) hi = min(hi, klast + a.window - q_offset);
  lo = (lo / kBq) * kBq;
  const int nqt = hi > lo ? (hi - lo + kBq - 1) / kBq : 0;
  const int nitems = G * nqt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {                         // the producer warp
    if (threadIdx.x == 128) {
      mbar_expect_tx(kv_full, 2 * W::kRowTile);
      tma_load_tile<HD>(k_s, &mk, kv_full, kRows, kvh, key0, b);
      tma_load_tile<HD>(v_s, &mv, kv_full, kRows, kvh, key0, b);
      for (int it = 0; it < nitems; ++it) {
        const int s = it % kStages;
        const int h = kvh * G + it / nqt;
        const int t0 = lo + (it % nqt) * kBq;
        if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * W::kQTile);
        uint8_t* qs = qd_s + s * 2 * W::kQTile;
        tma_load_tile<HD>(qs, &mq, &full[s], kBq, h, t0, b);
        tma_load_tile<HD>(qs + W::kQTile, &mdo, &full[s], kBq, h, t0, b);
      }
    }
    return;
  }

  const int t = static_cast<int>(threadIdx.x);
  const int lane = t % 32;
  const int c = lane % 4;
  const int r = 16 * (t / 32) + lane / 4;
  const int keys[2] = {key0 + r, key0 + r + 8};

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.0f;
  const uint32_t k_addr = smem_u32(k_s);
  const uint32_t v_addr = smem_u32(v_s);
  mbar_wait(kv_full, 0);

  for (int it = 0; it < nitems; ++it) {
    const int s = it % kStages;
    const int h = kvh * G + it / nqt;
    const int t0 = lo + (it % nqt) * kBq;
    // lse and delta of this thread's query columns 8 j + 2 c + e
    const long long rbase = (static_cast<long long>(b) * a.H + h) * a.Sq;
    float lse_c[kBq / 4], dlt_c[kBq / 4];
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = t0 + 8 * j + 2 * c + e;
        lse_c[2 * j + e] = qi < a.Sq ? a.lse[rbase + qi] : 0.0f;
        dlt_c[2 * j + e] = qi < a.Sq ? a.delta[rbase + qi] : 0.0f;
      }
    }
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t q_addr = smem_u32(qd_s + s * 2 * W::kQTile);
    const uint32_t do_addr = q_addr + W::kQTile;
    float st[kBq / 2], dpt[kBq / 2];
#pragma unroll
    for (int i = 0; i < kBq / 2; ++i) st[i] = dpt[i] = 0.0f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<kBq, 0>(st, desc_k_major<HD>(k_addr, kRows, 0, kk),
                       desc_k_major<HD>(q_addr, kBq, 0, kk), 1);
      wgmma_ss<kBq, 0>(dpt, desc_k_major<HD>(v_addr, kRows, 0, kk),
                       desc_k_major<HD>(do_addr, kBq, 0, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // every (key, query) pair of the tile visible: no mask
    const int qfirst = q_offset + t0;
    const int qlast = q_offset + t0 + kBq - 1;
    const bool partial = t0 + kBq > a.Sq || key0 + kRows > a.Skv
                         || (a.causal && klast > qfirst)
                         || (a.window > 0 && key0 <= qlast - a.window);
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * j + (e & 1);
        const int qi = t0 + 8 * j + 2 * c + (e & 1);
        const bool ok = !partial || (qi < a.Sq && sees(keys[e >> 1], q_offset + qi, a));
        const float p = ok ? expf(st[4 * j + e] * a.scale - lse_c[col]) : 0.0f;
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - dlt_c[col]);   // ds^T
      }
    }
    uint32_t ph[kBq / 16][4], pl[kBq / 16][4], dsh[kBq / 16][4], dsl[kBq / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk) {
      split_a(st, kk, ph[kk], pl[kk]);
      split_a(dpt, kk, dsh[kk], dsl[kk]);
    }
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dsh);
    fence_regs(dsl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk) {
      const uint64_t ddo = desc_mn_major<HD>(do_addr, kBq, kk);
      const uint64_t dqd = desc_mn_major<HD>(q_addr, kBq, kk);
      wgmma_rs<HD, 1>(dv, ph[kk], ddo, 1);
      wgmma_rs<HD, 1>(dv, pl[kk], ddo, 1);
      wgmma_rs<HD, 1>(dk, dsh[kk], dqd, 1);
      wgmma_rs<HD, 1>(dk, dsl[kk], dqd, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk);
    fence_regs(dv);
    mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk);
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (keys[hh] >= a.Skv) continue;
    const long long o = ((static_cast<long long>(b) * a.Skv + keys[hh]) * a.KV + kvh) * HD + 2 * c;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + o + 8 * j) = __floats2bfloat162_rn(
          dk[4 * j + 2 * hh] * a.scale, dk[4 * j + 2 * hh + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + o + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
    }
  }
}

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t s) {
  using W = Bwd<HD>;
  // dq pass: 64-row boxes of q, dO, k, v; dk/dv pass: kBq-row q, dO boxes
  CUtensorMap mq, mdo, mk, mv, mq2, mdo2;
  cudaError_t err = make_rows_map<HD>(&mq, a.q, a.B, a.Sq, a.H, a.q_sb, a.q_ss, kRows);
  if (err == cudaSuccess) err = make_rows_map<HD>(&mdo, a.dout, a.B, a.Sq, a.H, a.d_sb, a.d_ss, kRows);
  if (err == cudaSuccess) err = make_rows_map<HD>(&mk, a.k, a.B, a.Skv, a.KV, a.k_sb, a.k_ss, kRows);
  if (err == cudaSuccess) err = make_rows_map<HD>(&mv, a.v, a.B, a.Skv, a.KV, a.v_sb, a.v_ss, kRows);
  if (err == cudaSuccess) err = make_rows_map<HD>(&mq2, a.q, a.B, a.Sq, a.H, a.q_sb, a.q_ss, W::kBq);
  if (err == cudaSuccess) err = make_rows_map<HD>(&mdo2, a.dout, a.B, a.Sq, a.H, a.d_sb, a.d_ss, W::kBq);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, W::kDqSmem);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, W::kDkvSmem);
  }
  if (err != cudaSuccess) return err;
  const dim3 gq(a.B * a.H, (a.Sq + kRows - 1) / kRows);
  flash_bwd_dq_tc_kernel<HD><<<gq, kThreads, W::kDqSmem, s>>>(mq, mdo, mk, mv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gk(a.B * a.KV, (a.Skv + kRows - 1) / kRows);
  flash_bwd_dkv_tc_kernel<HD><<<gk, kThreads, W::kDkvSmem, s>>>(mq2, mdo2, mk, mv, a);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T, int HD>
cudaError_t launch_t(const Args& a, cudaStream_t s) {
  const dim3 gq((a.Sq + kRows - 1) / kRows, a.B * a.H);
  flash_bwd_dq_kernel<T, HD><<<gq, kThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gk((a.Skv + kRows - 1) / kRows, a.B * a.KV);
  flash_bwd_dkv_kernel<T, HD><<<gk, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Args& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_t<T, 32>(a, s);
    case 64: return launch_t<T, 64>(a, s);
    case 96: return launch_t<T, 96>(a, s);
    case 128: return launch_t<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Strides are in elements; the head and feature axes of q, k, v, out and
// dO must be contiguous ([.., H or KV, hd] rows of hd), every row 16-byte
// aligned. lse and delta are contiguous [B, H, Sq] f32; dq a contiguous
// [B, Sq, H, hd] buffer and dk, dv contiguous [B, Skv, KV, hd] buffers of
// q's dtype. dtype: 0 float32 (the CUDA-core kernels), 1 bfloat16 (the
// tensor-core kernels). hd in {32, 64, 96, 128}; H a multiple of KV;
// Sq <= Skv; q_offset, the absolute position of query row 0, in
// [0, Skv - Sq].
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* out,
                               const void* dout, const float* lse, float* delta, void* dq,
                               void* dk, void* dv, long long q_sb, long long q_ss,
                               long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                               long long o_sb, long long o_ss, long long d_sb, long long d_ss,
                               int B, int Sq, int Skv, int H, int KV, int hd, int causal,
                               int window, int q_offset, float scale, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV) {
    return cudaErrorInvalidValue;
  }
  if (B * H > 65535 || Sq > Skv) return cudaErrorInvalidValue;
  if (q_offset < 0 || q_offset > Skv - Sq) return cudaErrorInvalidValue;
  Args a{q, k, v, out, dout, lse, delta, dq, dk, dv,
         q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, d_sb, d_ss,
         B, Sq, Skv, H, KV, causal, window, q_offset, scale};
  if (dtype == 0) return launch_hd<float>(a, hd, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 32: return tc::launch<32>(a, s);
    case 64: return tc::launch<64>(a, s);
    case 96: return tc::launch<96>(a, s);
    case 128: return tc::launch<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
