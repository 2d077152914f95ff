// Decode attention for NVIDIA Hopper (sm_90a): one query token per
// sequence against a KV cache with kv_len valid rows, grouped-query heads.
//
//   q [B, 1, H, hd]; k, v caches [B, Skv, KV, hd] (f32 or bf16, one dtype);
//   query head h reads kv head h / G (G = H / KV); rows [0, kv_len) count,
//   in any order (under a sliding window the cache is a ring);
//   out [B, 1, H, hd] (q's dtype) = softmax(q k^T * scale) v.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:
// decode_attention_pallas (_kernel), whose grid walks kv blocks
// sequentially per (batch, kv head) with the online-softmax state of the G
// query heads in VMEM scratch, kv_len arriving by scalar prefetch. Here
// kv_len is a plain kernel argument (the caller keeps the position a host
// integer, so a decode step never waits on the device), and the cache axis
// is split across blocks (flash-decoding).
//
// Numerics as in the reference: q * scale rounded in f32, f32 scores,
// softmax state and sums, one rounding of the output to q's dtype. The
// reference masks rows >= kv_len with -1e30, which gives them weight
// exp(-1e30 - m) = 0; here they are not read at all.
//
// Bound: bytes. Each call reads the kv_len valid rows of both caches once
// (~1 flop per byte). Design: grid (n_split, B * H); a block of 128
// threads owns one (batch, head) and a contiguous run of the valid rows.
// It stages 32-row tiles of k and v in shared memory as f32 (16-byte
// loads, every thread several in flight; rows padded by 16 floats so the
// eight rows a warp touches fall in distinct banks). Scores: 4 threads per
// key, each an interleaved quarter of hd, added with two xor-shuffles. One
// warp takes the tile's max, the correction and the 32 weights; then each
// thread accumulates p_j * v_j for one column (and, for hd < 128, a subset
// of the keys). With n_split > 1 each block writes its unnormalised
// (acc, m, l) and a second kernel merges the splits per (batch, head);
// with n_split = 1 the block writes the output itself. The G heads of a kv
// head read the same rows, from L2 after the first.
//
// C interface (bound with ctypes): decode_attention_launch() returns the
// launch's cudaError_t; decode_attention_error_string() names it.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
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
  float* part;                        // [B * H, n_split, hd + 2] when n_split > 1
  long long k_sb, k_ss, v_sb, v_ss;   // batch / seq strides of the caches
  int H, KV, kv_len, keys_per_split, n_split;
  float scale;
};

template <typename T, int HD>
__device__ __forceinline__ void load_tile(float (*dst)[HD + kPad], const T* base,
                                          long long ss, int t0, int t1) {
  constexpr int kChunks = HD / 8;
  for (int idx = static_cast<int>(threadIdx.x); idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    float vals[8];
    if (t0 + r < t1) {
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
decode_partial_kernel(Args a) {
  constexpr int kQ = HD / 16;                  // float4 chunks per score thread
  constexpr int kParts = kThreads / HD;        // key subsets in the p.v phase (0 if HD > 128)
  static_assert(HD <= kThreads, "one p.v column per thread");
  __shared__ __align__(16) float ks[kTile][HD + kPad];
  __shared__ __align__(16) float vs[kTile][HD + kPad];
  __shared__ float ps[kTile];
  __shared__ float stat[3];                    // m, l, corr of the current tile
  __shared__ float red[kParts][HD];

  const int tid = static_cast<int>(threadIdx.x);
  const int bh = static_cast<int>(blockIdx.y);
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int split = static_cast<int>(blockIdx.x);
  const int j0 = split * a.keys_per_split;
  const int j1 = min(a.kv_len, j0 + a.keys_per_split);

  // score phase: key (tid / 4) of the tile, quarter (tid % 4) of hd
  const int skey = tid >> 2;
  const int quarter = tid & 3;
  const T* qp = static_cast<const T*>(a.q) + static_cast<long long>(bh) * HD;
  float qr[kQ][4];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) qr[i][e] = to_f(qp[16 * i + 4 * quarter + e]) * a.scale;
  }
  // p.v phase: column (tid % HD), keys j with j % kParts == tid / HD
  const int col = tid % HD;
  const int sub = tid / HD;
  const bool pv = sub < kParts;
  float acc = 0.0f;
  if (tid == 0) {
    stat[0] = kNegInf;
    stat[1] = 0.0f;
  }

  const T* kbase = static_cast<const T*>(a.k) + b * a.k_sb + static_cast<long long>(kvh) * HD;
  const T* vbase = static_cast<const T*>(a.v) + b * a.v_sb + static_cast<long long>(kvh) * HD;

  for (int t0 = j0; t0 < j1; t0 += kTile) {
    __syncthreads();                           // the previous tile is consumed
    load_tile<T, HD>(ks, kbase, a.k_ss, t0, j1);
    load_tile<T, HD>(vs, vbase, a.v_ss, t0, j1);
    __syncthreads();

    float d = 0.0f;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const float4 kv = *reinterpret_cast<const float4*>(&ks[skey][16 * i + 4 * quarter]);
      d = fmaf(qr[i][0], kv.x, d);
      d = fmaf(qr[i][1], kv.y, d);
      d = fmaf(qr[i][2], kv.z, d);
      d = fmaf(qr[i][3], kv.w, d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (quarter == 0) ps[skey] = (t0 + skey < j1) ? d : minus_inf();
    __syncthreads();

    if (tid < 32) {                            // one warp: the tile's softmax step
      const float s = ps[tid];
      float tmax = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m = stat[0];
      const float m_new = fmaxf(m, tmax);
      const float p = expf(s - m_new);         // 0 for the rows past j1
      float psum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      ps[tid] = p;
      __syncwarp();
      if (tid == 0) {
        const float corr = expf(m - m_new);
        stat[0] = m_new;
        stat[1] = stat[1] * corr + psum;
        stat[2] = corr;
      }
    }
    __syncthreads();

    if (pv) {
      acc *= stat[2];
#pragma unroll 8
      for (int j = sub; j < kTile; j += kParts) acc = fmaf(ps[j], vs[j][col], acc);
    }
  }

  // fold the key subsets of the p.v phase (fixed order)
  if (pv) red[sub][col] = acc;
  __syncthreads();
  if (sub != 0) return;
  acc = red[0][col];
#pragma unroll
  for (int p = 1; p < kParts; ++p) acc += red[p][col];
  const float m = stat[0], l = stat[1];
  if (a.n_split == 1) {
    T* op = static_cast<T*>(a.out) + static_cast<long long>(bh) * HD;
    op[col] = from_f<T>(acc / fmaxf(l, 1e-30f));
  } else {
    float* pp = a.part + (static_cast<long long>(bh) * a.n_split + split) * (HD + 2);
    pp[col] = acc;
    if (col == 0) {
      pp[HD] = m;
      pp[HD + 1] = l;
    }
  }
}

// Merge the n_split partial (acc, m, l) of one (batch, head) in split order.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_merge_kernel(const float* __restrict__ part, T* __restrict__ out, int n_split) {
  const int bh = static_cast<int>(blockIdx.x);
  const int col = static_cast<int>(threadIdx.x);
  const float* pp = part + static_cast<long long>(bh) * n_split * (HD + 2);
  float m = kNegInf;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, pp[s * (HD + 2) + HD]);
  float l = 0.0f, acc = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(pp[s * (HD + 2) + HD] - m);
    l = fmaf(pp[s * (HD + 2) + HD + 1], w, l);
    acc = fmaf(pp[s * (HD + 2) + col], w, acc);
  }
  out[static_cast<long long>(bh) * HD + col] = from_f<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int BH, cudaStream_t s) {
  decode_partial_kernel<T, HD><<<dim3(a.n_split, BH), kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  decode_merge_kernel<T, HD><<<BH, HD, 0, s>>>(a.part, static_cast<T*>(a.out), a.n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Args& a, int BH, int hd, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(a, BH, s);
    case 64: return launch<T, 64>(a, BH, s);
    case 96: return launch<T, 96>(a, BH, s);
    case 128: return launch<T, 128>(a, BH, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: contiguous [B, 1, H, hd]; k, v: [B, Skv, KV, hd] with contiguous
// (KV, hd) rows and the given batch / seq strides (elements), every row
// 16-byte aligned; out: contiguous like q. part: f32 scratch of
// B * H * n_split * (hd + 2) values (unused when n_split == 1). The splits
// cover [0, kv_len) in runs of keys_per_split rows, none empty.
// dtype: 0 float32, 1 bfloat16; hd in {32, 64, 96, 128}.
int decode_attention_launch(const void* q, const void* k, const void* v, void* out,
                            float* part, long long k_sb, long long k_ss, long long v_sb,
                            long long v_ss, int B, int H, int KV, int hd, int kv_len,
                            int keys_per_split, int n_split, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || kv_len <= 0 || n_split <= 0
      || keys_per_split <= 0 || B * H > 65535 || n_split > 65535
      || static_cast<long long>(n_split - 1) * keys_per_split >= kv_len
      || static_cast<long long>(n_split) * keys_per_split < kv_len) {
    return cudaErrorInvalidValue;
  }
  Args a{q, k, v, out, part, k_sb, k_ss, v_sb, v_ss, H, KV, kv_len, keys_per_split,
         n_split, scale};
  if (dtype == 0) return launch_hd<float>(a, B * H, hd, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, B * H, hd, s);
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
