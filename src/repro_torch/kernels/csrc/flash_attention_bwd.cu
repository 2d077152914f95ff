// Flash-attention backward for NVIDIA Hopper (sm_90a): dq, dk and dv of
// causal or windowed grouped-query attention, from the forward's inputs,
// its output and per-row log-sum-exp, and dO; f32 math.
//
//   q, out, dO [B, Sq, H, hd], k, v [B, Skv, KV, hd] (f32 or bf16, all one
//   dtype); query head h reads kv head h / G (G = H / KV); query i sits at
//   absolute position q_pos = (Skv - Sq) + i; key j is visible where
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
// Two kernels, one launch each, on one stream:
// * dq: a block owns 32 query rows of one (batch, head), 4 threads a row,
//   each holding an interleaved quarter of q (scaled, rounded in f32),
//   dO and the dq accumulator in registers (float4 chunks at columns
//   16 i + 4 p, as the forward kernel). A prologue computes the row's delta
//   from dO and O (two xor-shuffles) and stores it for the dk/dv pass. The
//   block walks 32-key tiles of k and v staged as f32 in padded shared
//   memory; per key the row's 4 threads reduce s = q k and dP = dO v with
//   xor-shuffles, then p = exp(s - lse) (0 where masked), ds = p (dP -
//   delta), dq += ds k. Tiles no row of the block can see are skipped.
// * dk/dv: a block owns 32 key rows of one (batch, kv head), k, v and the
//   dk, dv accumulators split over the row's 4 threads the same way. It
//   walks all G query heads of its kv head and, for each, only the query
//   rows that can see one of its keys (causal: q_pos >= its first key;
//   window: q_pos < its last key + window; shifted by Skv - Sq), staging
//   32 rows of q * scale and dO, and their lse and delta, per tile in
//   shared memory; dv += p dO, dk += ds (q scale). One pass replaces the
//   reference's G calls and G - 1 adds: the sum over the group stays in
//   f32 registers and is rounded once.
//
// Numerics as the forward kernel and the reference: q * scale rounded in
// f32 before the products, f32 scores, p, ds and sums, one rounding out.
//
// Bound: operations, 10 hd flops per visible (query, key) pair (s, dP, dq,
// dk, dv) against ~67 MB moved at qwen1.5-0.5b's training shape. This first
// version runs on the CUDA cores in f32 (wgmma is later work); per pair
// every thread reads its quarter of one k / v row (dq) or one q / dO row
// (dk/dv) from shared memory, a broadcast across the warp.
//
// C interface (bound with ctypes): flash_attention_bwd_launch() returns the
// first launch error (cudaError_t); flash_attention_bwd_error_string()
// names it.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ void load_f32x8(const __nv_bfloat16* p, float* d) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
  int B, Sq, Skv, H, KV, causal, window;
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
  const int q_offset = a.Skv - a.Sq;
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
  const int q_offset = a.Skv - a.Sq;

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
// q's dtype. dtype: 0 float32, 1 bfloat16. hd in {32, 64, 96, 128}; H a
// multiple of KV; Sq <= Skv.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* out,
                               const void* dout, const float* lse, float* delta, void* dq,
                               void* dk, void* dv, long long q_sb, long long q_ss,
                               long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                               long long o_sb, long long o_ss, long long d_sb, long long d_ss,
                               int B, int Sq, int Skv, int H, int KV, int hd, int causal,
                               int window, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV) {
    return cudaErrorInvalidValue;
  }
  if (B * H > 65535 || Sq > Skv) return cudaErrorInvalidValue;
  Args a{q, k, v, out, dout, lse, delta, dq, dk, dv,
         q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, d_sb, d_ss,
         B, Sq, Skv, H, KV, causal, window, scale};
  if (dtype == 0) return launch_hd<float>(a, hd, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, hd, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
