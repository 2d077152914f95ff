// Flash-attention forward with the per-row log-sum-exp, for NVIDIA Hopper
// (sm_90a): causal or windowed grouped-query attention, online softmax.
//
//   q [B, Sq, H, hd], k, v [B, Skv, KV, hd] (f32 or bf16, all one dtype);
//   query head h reads kv head h / G (G = H / KV); query i sits at absolute
//   position q_pos = q_offset + i (0 <= q_offset <= Skv - Sq; the last Sq
//   positions at q_offset = Skv - Sq, a sequence shard's rows at its own
//   offset); key j is visible where j < Skv, and
//   j <= q_pos if causal, and j > q_pos - window if window > 0;
//   out [B, Sq, H, hd] (q's dtype) = softmax(q k^T * scale) v per row;
//   lse [B * KV, G, Sq] f32 = m + log(max(l, 1e-30)).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fwd_pallas (_kernel_fwd_lse over _kernel), whose grid
// walks kv blocks sequentially with m / l / acc in VMEM scratch. Here a
// block owns a stretch of query rows of one (batch, head) and walks the kv
// tiles in a loop, m / l / acc in registers. Two routes, by dtype (not a
// fallback: a launch that fails returns its error):
//
// * bf16 inputs: the tensor-core kernel (namespace tc, below). Scores and
//   the output sum on bf16 wgmma with f32 accumulation; a product of two
//   bf16 values is exact in f32, so S = q k^T is the reference's f32 score
//   up to summation order (scale is applied to the f32 scores after the
//   product, where the reference rounds q * scale first). P is f32: it is
//   split into hi = bf16(P) and lo = bf16(P - hi) and P V is issued twice
//   (hi, then lo) into the f32 accumulator, which keeps the reference's
//   parity bound (a single bf16 P leaves it: tests/
//   test_torch_flash_tc_numerics.py). Softmax in f32 with expf, as the
//   reference's exp; out rounded once. Bound: bytes at qwen1.5-0.5b's
//   prefill (~127 flops a byte against the card's ~295 bf16 flops a byte),
//   operations at qwen2.5-3b's (~450: G 8, S 1024); the split adds a third
//   product unit to the usual two. Design: a block of
//   two consumer warpgroups (64 query rows each, 128 a block) and one
//   producer warp. The producer's lane 0 loads the block's q tile once and
//   the k / v tiles (128 keys at hd 32, else 64) into a 2-stage ring by
//   TMA (128- or 64-byte swizzled, what wgmma reads without bank
//   conflicts; rows past Skv or Sq zero filled), completing on mbarriers;
//   each warpgroup waits for a stage, runs S = q k^T (wgmma SS, k K-major),
//   the online softmax on the accumulator fragments (row max and sum over
//   the 4 threads of a row with xor-shuffles), O += P_hi V + P_lo V (wgmma
//   RS, P from registers, V read MN-major), and releases the stage. Only
//   tiles that cross the causal diagonal, the window's edge or Skv are
//   masked; a tile no row of a warpgroup sees is skipped by it; blocks run
//   heaviest (last query rows) first.
// * f32 inputs: the CUDA-core kernel below (flash_fwd_kernel), f32 math as
//   the reference: q * scale rounded in f32 before the product; scores,
//   softmax state and the output sum f32. Bound: operations (f32 outside
//   the tensor cores); per block of 128 threads, 4 threads a query row
//   (32 rows a block), each holding an interleaved quarter of q and acc in
//   registers (float4 chunks at columns 16 i + 4 p); a 32-key tile of k
//   and v in padded shared memory (16 floats a row, so the eight rows a
//   warp touches fall in distinct banks); per key the row's 4 threads add
//   their partial dots with two xor-shuffles; then acc += p_j * v_j.
//
// Both routes: the reference sets masked scores to -1e30 and lets the next
// real score's correction exp(-1e30 - m) zero what a wholly masked stretch
// added; here a masked score gets weight 0 outright and a tile no row can
// see is skipped. Every row sees at least its own position, so both give
// the sum over the visible keys: the same output up to f32 rounding order.
//
// C interface (bound with ctypes): flash_attention_launch() returns the
// launch's cudaError_t; flash_attention_error_string() names it.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

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

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;   // batch / seq strides
  int B, Sq, Skv, H, KV, causal, window, q_offset;
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
  const int q_offset = a.q_offset;
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

// ------------------------------------------------------- bf16: tensor cores
namespace tc {

using namespace hopper_tc;

constexpr int kConsumers = 2;                       // warpgroups of 64 query rows
constexpr int kWgRows = 64;
constexpr int kBlockRows = kConsumers * kWgRows;    // query rows a block
constexpr int kThreads = 128 * kConsumers + 32;     // + the producer warp
constexpr int kStages = 2;                          // k / v ring

template <int HD>
struct Fwd {
  static constexpr int kBc = HD <= 32 ? 128 : 64;   // keys a tile (168 registers a thread)
  static constexpr int kQBytes = kBlockRows * HD * 2;
  static constexpr int kTileBytes = kBc * HD * 2;   // one k or v tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  static constexpr int kSmem = kBarOffset + 64 + 1024;  // + barriers, alignment
};

struct Args {
  void* out;
  float* lse;
  int B, Sq, Skv, H, KV, causal, window, q_offset;
  float scale;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, Args a) {
  using F = Fwd<HD>;
  constexpr int kBc = F::kBc;
  uint8_t* smem = smem_1024();
  uint8_t* q_s = smem;
  uint8_t* kv_s = smem + F::kQBytes;                // stage s: k, then v
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + F::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = static_cast<int>(blockIdx.x);
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int row0 = (static_cast<int>(gridDim.y - 1 - blockIdx.y)) * kBlockRows;  // heaviest first
  const int q_offset = a.q_offset;

  // the block's rows cover positions [first, last]; skip tiles none sees
  const int first = q_offset + row0;
  const int last = q_offset + min(a.Sq - 1, row0 + kBlockRows - 1);
  int lo = 0, hi = a.Skv;
  if (a.causal) hi = min(hi, last + 1);
  if (a.window > 0) lo = max(0, first - a.window + 1);
  lo = (lo / kBc) * kBc;
  const int ntiles = (hi - lo + kBc - 1) / kBc;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = static_cast<int>(threadIdx.x) / 128;
  if (wg == kConsumers) {                           // the producer warp
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(q_full, F::kQBytes);
      tma_load_tile<HD>(q_s, &mq, q_full, kBlockRows, h, row0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * F::kTileBytes);
        uint8_t* ks = kv_s + s * 2 * F::kTileBytes;
        tma_load_tile<HD>(ks, &mk, &full[s], kBc, kvh, lo + it * kBc, b);
        tma_load_tile<HD>(ks + F::kTileBytes, &mv, &full[s], kBc, kvh, lo + it * kBc, b);
      }
    }
    return;
  }

  // a consumer warpgroup: rows [wrow0, wrow0 + 64) of the block; this
  // thread holds rows r and r + 8 of them, columns 8 j + 2 c + {0, 1}
  const int t = static_cast<int>(threadIdx.x) % 128;
  const int lane = t % 32;
  const int c = lane % 4;
  const int r = 16 * (t / 32) + lane / 4;
  const int wrow0 = row0 + wg * kWgRows;
  const bool wg_active = wrow0 < a.Sq;
  const int wfirst = q_offset + wrow0;
  const int wlast = q_offset + min(a.Sq - 1, wrow0 + kWgRows - 1);
  const int qpos[2] = {wfirst + r, wfirst + r + 8};
  const float neg_inf = __int_as_float(0xff800000);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};
  const uint32_t q_addr = smem_u32(q_s);
  mbar_wait(q_full, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    const int t0 = lo + it * kBc;
    mbar_wait(&full[s], (it / kStages) & 1);
    const bool skip = !wg_active || (a.causal && t0 > wlast)
                      || (a.window > 0 && t0 + kBc - 1 <= wfirst - a.window);
    if (!skip) {
      const uint32_t k_addr = smem_u32(kv_s + s * 2 * F::kTileBytes);
      const uint32_t v_addr = k_addr + F::kTileBytes;
      float sc[kBc / 2];
#pragma unroll
      for (int i = 0; i < kBc / 2; ++i) sc[i] = 0.0f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wgmma_ss<kBc, 0>(sc, desc_k_major<HD>(q_addr, kBlockRows, wg * kWgRows, kk),
                         desc_k_major<HD>(k_addr, kBc, 0, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // f32 scores, masked where the tile crosses the diagonal, the
      // window's edge or Skv
      const bool partial = t0 + kBc > a.Skv || (a.causal && t0 + kBc - 1 > wfirst)
                           || (a.window > 0 && t0 <= wlast - a.window);
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * a.scale;
          if (partial) {
            const int key = t0 + 8 * j + 2 * c + (e & 1);
            const int qp = qpos[e >> 1];
            const bool ok = key < a.Skv && (!a.causal || key <= qp)
                            && (a.window <= 0 || key > qp - a.window);
            x = ok ? x : neg_inf;
          }
          sc[4 * j + e] = x;
        }
      }
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tmax = neg_inf;
#pragma unroll
        for (int j = 0; j < kBc / 8; ++j) {
          tmax = fmaxf(tmax, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
        }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m[hh], tmax);
        corr[hh] = expf(m[hh] - m_new);
        m[hh] = m_new;
        float psum = 0.0f;                          // this thread's part of the row
#pragma unroll
        for (int j = 0; j < kBc / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(sc[4 * j + 2 * hh + e] - m_new);  // 0 where masked
            sc[4 * j + 2 * hh + e] = p;
            psum += p;
          }
        }
        l[hh] = l[hh] * corr[hh] + psum;
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
      }

      // O += P_hi V + P_lo V
      uint32_t ph[kBc / 16][4], pl[kBc / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk) split_a(sc, kk, ph[kk], pl[kk]);
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk) {
        const uint64_t dv = desc_mn_major<HD>(v_addr, kBc, kk);
        wgmma_rs<HD, 1>(o, ph[kk], dv, 1);
        wgmma_rs<HD, 1>(o, pl[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    mbar_arrive(&empty[s]);
  }

  if (!wg_active) return;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh] + __shfl_xor_sync(0xffffffffu, l[hh], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = wrow0 + r + 8 * hh;
    if (row >= a.Sq) continue;
    const float inv = 1.0f / fmaxf(lt, 1e-30f);
    __nv_bfloat16* op = out + ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * HD + 2 * c;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    }
    // [B * KV, G, Sq] with h = kvh * G + g is [B, H, Sq]
    if (c == 0) {
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + row] = m[hh] + logf(fmaxf(lt, 1e-30f));
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, long long q_sb, long long q_ss,
                   long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                   const Args& a, cudaStream_t s) {
  using F = Fwd<HD>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_rows_map<HD>(&mq, q, a.B, a.Sq, a.H, q_sb, q_ss, kBlockRows);
  if (err == cudaSuccess) err = make_rows_map<HD>(&mk, k, a.B, a.Skv, a.KV, k_sb, k_ss, F::kBc);
  if (err == cudaSuccess) err = make_rows_map<HD>(&mv, v, a.B, a.Skv, a.KV, v_sb, v_ss, F::kBc);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fwd_tc_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sq + kBlockRows - 1) / kBlockRows);
  flash_fwd_tc_kernel<HD><<<grid, kThreads, F::kSmem, s>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

}  // namespace tc

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
// [B, H, Sq] f32 buffer. dtype: 0 float32 (the CUDA-core kernel), 1
// bfloat16 (the tensor-core kernel). hd in {32, 64, 96, 128}; H a multiple
// of KV; q_offset, the absolute position of query row 0, in [0, Skv - Sq].
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           float* lse, long long q_sb, long long q_ss, long long k_sb,
                           long long k_ss, long long v_sb, long long v_ss, int B, int Sq,
                           int Skv, int H, int KV, int hd, int causal, int window,
                           int q_offset, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV) {
    return cudaErrorInvalidValue;
  }
  if (B * H > 65535 || Sq > Skv) return cudaErrorInvalidValue;
  if (q_offset < 0 || q_offset > Skv - Sq) return cudaErrorInvalidValue;
  if (dtype == 0) {
    Args a{q, k, v, out, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
           B, Sq, Skv, H, KV, causal, window, q_offset, scale};
    return launch_hd<float>(a, hd, s);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const tc::Args a{out, lse, B, Sq, Skv, H, KV, causal, window, q_offset, scale};
  switch (hd) {
    case 32: return tc::launch<32>(q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, a, s);
    case 64: return tc::launch<64>(q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, a, s);
    case 96: return tc::launch<96>(q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, a, s);
    case 128: return tc::launch<128>(q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, a, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
