// Gated weighted client mean for NVIDIA Hopper (sm_90a).
//
//   out[m] = sum_k wg_k u[k, m] / sum_k wg_k,   wg_k = w_k * g_k,
//
// summed over the included rows (wg_k > 0), accumulated in f32 and written
// in the input dtype (f32 or bf16). Zero inclusion mass gives exact zeros.
//
// Replaces the TPU kernel repro/kernels/fedagg.py:_mean_kernel with the
// identity wire decode (_decode_identity), launched by fedagg_pallas. The
// TPU version holds a whole [C, block_m] slab in VMEM and contracts it on
// the MXU; here a block's shared memory cannot hold C rows of a wide tile,
// and the contraction is ~1 FLOP per 2 bytes, so there is nothing for
// tensor cores to do.
//
// Bound: bytes. The least traffic is one read of every included row and
// one write of the output. The design does two things about it:
//   * one streaming pass: each thread owns VW adjacent columns and walks
//     down the included rows with VW-wide (up to 16-byte) coalesced loads,
//     kUnroll rows in flight, the sums in registers;
//   * gated-out rows are never read: each block compacts the included row
//     indices into shared memory first. This also keeps a NaN in an
//     excluded row out of the sum, as the reference's where() does.
// The gate vector is staged in chunks of kThreads rows, so any C works.
// The denominator is reduced in a fixed order (warp tree, then warps in
// order), so every block divides by the same value.
//
// C interface (bound with ctypes): fedagg_mean() returns the launch's
// cudaError_t; fedagg_error_string() names it.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

// Elements are held as their storage type S: float, or uint16_t holding
// the bits of a bf16 (bf16 -> f32 is exact: the bits go to the top half).
__device__ __forceinline__ float to_f32(float x) { return x; }
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

template <typename S, int VW>
__global__ void __launch_bounds__(kThreads)
    fedagg_mean_kernel(const S* __restrict__ u, long long ld,
                       const float* __restrict__ w,
                       const float* __restrict__ g, S* __restrict__ out,
                       int C, long long M) {
  __shared__ int s_row[kThreads];
  __shared__ float s_wg[kThreads];
  __shared__ int s_warp_n[kWarps];
  __shared__ float s_warp_den[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long col = (static_cast<long long>(blockIdx.x) * kThreads + tid) * VW;
  const bool live = col < M;
  const bool full = col + VW <= M;  // else this thread holds the ragged tail

  float acc[VW];
#pragma unroll
  for (int i = 0; i < VW; ++i) acc[i] = 0.f;
  float den = 0.f;

  for (int c0 = 0; c0 < C; c0 += kThreads) {
    // stage this chunk's gate weights and compact the included rows, in
    // row order, with one ballot per warp
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
      s_wg[pos] = wg;
    }
    __syncthreads();

    if (full) {
      int j = 0;
      for (; j + kUnroll <= n; j += kUnroll) {
        Pack<S, VW> p[kUnroll];
#pragma unroll
        for (int r = 0; r < kUnroll; ++r)
          p[r] = load_pack<S, VW>(u + static_cast<long long>(s_row[j + r]) * ld + col);
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) {
          const float wr = s_wg[j + r];
#pragma unroll
          for (int i = 0; i < VW; ++i) acc[i] = fmaf(wr, to_f32(p[r].v[i]), acc[i]);
        }
      }
      for (; j < n; ++j) {
        const Pack<S, VW> p =
            load_pack<S, VW>(u + static_cast<long long>(s_row[j]) * ld + col);
        const float wr = s_wg[j];
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] = fmaf(wr, to_f32(p.v[i]), acc[i]);
      }
    } else if (live) {
      // scalar tail for a ragged M
      for (int j = 0; j < n; ++j) {
        const S* row = u + static_cast<long long>(s_row[j]) * ld;
        const float wr = s_wg[j];
        for (int i = 0; i < VW && col + i < M; ++i)
          acc[i] = fmaf(wr, to_f32(row[col + i]), acc[i]);
      }
    }
    __syncthreads();  // the next chunk overwrites s_row / s_wg
  }

  if (!live) return;
  const bool has_mass = den > 0.f;
  const float safe = fmaxf(den, 1e-30f);
  Pack<S, VW> o;
#pragma unroll
  for (int i = 0; i < VW; ++i) o.v[i] = from_f32<S>(has_mass ? acc[i] / safe : 0.f);
  if (full) {
    *reinterpret_cast<typename RawT<sizeof(S) * VW>::type*>(out + col) = o.raw;
  } else {
    for (int i = 0; i < VW && col + i < M; ++i) out[col + i] = o.v[i];
  }
}

template <typename S, int VW>
cudaError_t launch(const void* u, long long ld, const float* w,
                   const float* g, void* out, int C, long long M,
                   cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * VW;
  const long long blocks = (M + per_block - 1) / per_block;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  fedagg_mean_kernel<S, VW><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const S*>(u), ld, w, g, static_cast<S*>(out), C, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vw: elements per load; the caller
// guarantees ld % vw == 0 and that u and out are aligned to vw elements.
int fedagg_mean(int dtype, int vw, const void* u, long long ld,
                const void* w, const void* g, void* out, int C, long long M,
                void* stream) {
  const auto* wf = static_cast<const float*>(w);
  const auto* gf = static_cast<const float*>(g);
  auto s = static_cast<cudaStream_t>(stream);
  if (C < 0 || M < 0 || ld < M) return cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vw) {
      case 4: return launch<float, 4>(u, ld, wf, gf, out, C, M, s);
      case 2: return launch<float, 2>(u, ld, wf, gf, out, C, M, s);
      case 1: return launch<float, 1>(u, ld, wf, gf, out, C, M, s);
    }
  } else if (dtype == 1) {
    switch (vw) {
      case 8: return launch<uint16_t, 8>(u, ld, wf, gf, out, C, M, s);
      case 4: return launch<uint16_t, 4>(u, ld, wf, gf, out, C, M, s);
      case 2: return launch<uint16_t, 2>(u, ld, wf, gf, out, C, M, s);
      case 1: return launch<uint16_t, 1>(u, ld, wf, gf, out, C, M, s);
    }
  }
  return cudaErrorInvalidValue;
}

const char* fedagg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
