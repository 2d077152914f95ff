// Flash-attention forward with the per-row log-sum-exp, for NVIDIA Hopper
// (sm_90a): causal or windowed grouped-query attention, online softmax,
// f32 math.
//
//   q [B, Sq, H, hd], k, v [B, Skv, KV, hd] (f32 or bf16, all one dtype);
//   query head h reads kv head h / G (G = H / KV); query i sits at absolute
//   position q_pos = (Skv - Sq) + i; key j is visible where j < Skv, and
//   j <= q_pos if causal, and j > q_pos - window if window > 0;
//   out [B, Sq, H, hd] (q's dtype) = softmax(q k^T * scale) v per row;
//   lse [B * KV, G, Sq] f32 = m + log(max(l, 1e-30)).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fwd_pallas (_kernel_fwd_lse over _kernel), whose grid
// walks kv blocks sequentially with m / l / acc in VMEM scratch. Here a
// block owns 32 query rows of one (batch, head) and walks the kv tiles in a
// loop, m / l / acc in registers.
//
// Numerics as in the reference: q * scale is rounded in f32 before the
// product; scores, softmax state and the output sum are f32; the output is
// rounded once to q's dtype. The reference sets masked scores to -1e30 and
// lets the next real score's correction exp(-1e30 - m) zero what a wholly
// masked stretch added; here a masked score gets weight 0 outright and a
// tile no row of the block can see is skipped. Every row sees at least
// its own position, so both give the sum over the visible keys: the same
// output up to f32 rounding order.
//
// Bound: operations (2 * 2 * hd flops per visible (query, key) pair; a
// causal prefill at S = 512, hd = 64 does ~34 flops per byte of q, k, v
// and out, above the card's ~20 f32 flops per byte). This first version
// runs on the CUDA cores in f32, not on the tensor cores (wgmma is later
// work). Design, per block of 128 threads: 4 threads per query row, each
// holding an interleaved quarter of q (scaled) and of acc in registers
// (float4 chunks at columns 16 i + 4 p); a 32-key tile of k and v is
// converted to f32 in shared memory (rows padded by 16 floats so the eight
// rows a warp touches fall in distinct banks); per key the 4 threads of a
// row add their partial dots with two xor-shuffles, so every thread of the
// row holds the score; the tile's max, the correction and the weights are
// computed per row in registers; then acc += p_j * v_j from shared memory.
// Tiles wholly outside every row's causal / window range are not loaded.
//
// C interface (bound with ctypes): flash_attention_launch() returns the
// launch's cudaError_t; flash_attention_error_string() names it.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = kThreads / 4;  // query rows per block
constexpr int kTile = 32;            // keys per tile
constexpr int kPad = 16;             // floats of padding per shared row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float minus_inf() { return __int_as_float(0xff800000); }

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
  void* out;
  float* lse;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;   // batch / seq strides
  int B, Sq, Skv, H, KV, causal, window;
  float scale;
};

// Stage keys [t0, t0 + kTile) of kv head kvh into shared memory as f32;
// rows past Skv are zero (their weight is 0, and 0 * garbage could be NaN).
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float (*dst)[HD + kPad], const T* base,
                                          long long ss, int t0, int Skv) {
  constexpr int kChunks = HD / 8;              // 8 values a load
  for (int idx = static_cast<int>(threadIdx.x); idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    float vals[8];
    if (t0 + r < Skv) {
      load_f32x8(base + (t0 + r) * ss + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = 0.0f;
    }
    *reinterpret_cast<float4*>(&dst[r][c]) = make_float4(vals[0], vals[1], vals[2], vals[3]);
    *reinterpret_cast<float4*>(&dst[r][c + 4]) = make_float4(vals[4], vals[5], vals[6], vals[7]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Args a) {
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

  // this thread's quarter of q (scaled, rounded in f32) and of acc
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + qrow * a.q_ss
                + static_cast<long long>(h) * HD;
  float qr[kQ][4], acc[kQ][4];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[i][e] = to_f(qp[16 * i + 4 * part + e]) * a.scale;
      acc[i][e] = 0.0f;
    }
  }
  float m = kNegInf, l = 0.0f;

  // the block's rows cover positions [first, last]; skip tiles none sees
  const int first = q_offset + row0;
  const int last = q_offset + min(a.Sq - 1, row0 + kRows - 1);
  int lo = 0, hi = a.Skv;
  if (a.causal) hi = min(hi, last + 1);
  if (a.window > 0) lo = max(0, first - a.window + 1);
  lo = (lo / kTile) * kTile;

  const T* kbase = static_cast<const T*>(a.k) + b * a.k_sb + static_cast<long long>(kvh) * HD;
  const T* vbase = static_cast<const T*>(a.v) + b * a.v_sb + static_cast<long long>(kvh) * HD;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    __syncthreads();                           // the previous tile is consumed
    load_tile<T, HD>(ks, kbase, a.k_ss, t0, a.Skv);
    load_tile<T, HD>(vs, vbase, a.v_ss, t0, a.Skv);
    __syncthreads();

    float s[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float d = 0.0f;
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[j][16 * i + 4 * part]);
        d = fmaf(qr[i][0], kv.x, d);
        d = fmaf(qr[i][1], kv.y, d);
        d = fmaf(qr[i][2], kv.z, d);
        d = fmaf(qr[i][3], kv.w, d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      s[j] = d;
    }
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int kp = t0 + j;
      const bool ok = kp < a.Skv && (!a.causal || kp <= q_pos)
                      && (a.window <= 0 || kp > q_pos - a.window);
      s[j] = ok ? s[j] : minus_inf();
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = expf(s[j] - m_new);               // exp(-inf) = 0 where masked
      psum += s[j];
    }
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][16 * i + 4 * part]);
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
  }

  if (!active) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* op = static_cast<T*>(a.out) + ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * HD;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) op[16 * i + 4 * part + e] = from_f<T>(acc[i][e] * inv);
  }
  if (part == 0) {
    // [B * KV, G, Sq] with h = kvh * G + g is [B, H, Sq]
    a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + row] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <typename T>
cudaError_t launch_hd(const Args& a, int hd, cudaStream_t s) {
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.B * a.H);
  switch (hd) {
    case 32: flash_fwd_kernel<T, 32><<<grid, kThreads, 0, s>>>(a); break;
    case 64: flash_fwd_kernel<T, 64><<<grid, kThreads, 0, s>>>(a); break;
    case 96: flash_fwd_kernel<T, 96><<<grid, kThreads, 0, s>>>(a); break;
    case 128: flash_fwd_kernel<T, 128><<<grid, kThreads, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements; the head and feature axes of q, k and v must be
// contiguous ([.., H or KV, hd] rows of hd), every row 16-byte aligned.
// out is a contiguous [B, Sq, H, hd] buffer of q's dtype, lse a contiguous
// [B, H, Sq] f32 buffer. dtype: 0 float32, 1 bfloat16. hd in {32, 64, 96,
// 128}; H a multiple of KV.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           float* lse, long long q_sb, long long q_ss, long long k_sb,
                           long long k_ss, long long v_sb, long long v_ss, int B, int Sq,
                           int Skv, int H, int KV, int hd, int causal, int window,
                           float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV) {
    return cudaErrorInvalidValue;
  }
  if (B * H > 65535 || Sq > Skv) return cudaErrorInvalidValue;
  Args a{q, k, v, out, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
         B, Sq, Skv, H, KV, causal, window, scale};
  if (dtype == 0) return launch_hd<float>(a, hd, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, hd, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
