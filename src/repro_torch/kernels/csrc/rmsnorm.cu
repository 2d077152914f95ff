// Row-wise RMSNorm for NVIDIA Hopper (sm_90a):
//
//   out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale[:]
//
// f32 inside, one rounding to x's dtype at the end (bf16 in -> f32 -> bf16
// out), the sum of squares over D in f32, any number of rows.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:rmsnorm_pallas (its
// _kernel normalises block_r rows of a [R, D] tile in one VMEM pass). The
// reference's models call the plain jnp models/layers.py:rmsnorm, which
// computes the same function; the port's models call this kernel for every
// block's norm1 / norm2 and the final norm.
//
// Bound: bytes. Each row is read from device memory once and written once
// (~1 flop per byte). Design: one warp per row, eight rows per block. Each
// lane walks the row with 16-byte loads (4 f32 or 8 bf16 values; a scalar
// path when D or the pointers do not allow it), summing squares in f32 in
// registers; a warp shuffle tree gives the row sum; a second pass reads the
// row again (it is at most 12 KB, so from L1/L2, not device memory) and
// writes (x * r) * scale rounded once. No shared memory, no block barrier.
//
// C interface (bound with ctypes): rmsnorm_launch() returns the launch's
// cudaError_t; rmsnorm_error_string() names it.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;           // rows per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VW>
struct alignas(sizeof(T) * VW) Vec {
  T v[VW];
};

template <typename T, typename S, int VW>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, long long rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;          // whole warps only: no barrier below
  const T* xr = x + row * D;
  T* orow = out + row * D;
  float ss = 0.0f;
  for (int c = lane * VW; c < D; c += 32 * VW) {
    const Vec<T, VW> a = *reinterpret_cast<const Vec<T, VW>*>(xr + c);
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      const float f = to_f(a.v[i]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float var = ss / static_cast<float>(D);
  const float r = 1.0f / sqrtf(var + eps);     // IEEE sqrt and divide
  for (int c = lane * VW; c < D; c += 32 * VW) {
    const Vec<T, VW> a = *reinterpret_cast<const Vec<T, VW>*>(xr + c);
    Vec<T, VW> o;
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      o.v[i] = from_f<T>((to_f(a.v[i]) * r) * to_f(scale[c + i]));
    }
    *reinterpret_cast<Vec<T, VW>*>(orow + c) = o;
  }
}

template <typename T, typename S, int VW>
cudaError_t launch(const void* x, const void* scale, void* out, long long rows,
                   int D, float eps, cudaStream_t s) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rmsnorm_kernel<T, S, VW><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out),
      rows, D, eps);
  return cudaGetLastError();
}

template <typename T, int VW>
cudaError_t by_scale(const void* x, const void* scale, void* out, long long rows,
                     int D, float eps, int scale_dtype, cudaStream_t s) {
  if (scale_dtype == 0) return launch<T, float, VW>(x, scale, out, rows, D, eps, s);
  if (scale_dtype == 1) return launch<T, __nv_bfloat16, VW>(x, scale, out, rows, D, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, out: [rows, D] row-major, dtype 0 float32 / 1 bfloat16 (the same for
// both); scale: [D], scale_dtype 0 / 1. vw: elements per load (f32: 4 or
// 1, bf16: 8 or 1); the caller picks 1 unless D and every pointer allow
// the 16-byte load.
int rmsnorm_launch(const void* x, const void* scale, void* out, long long rows,
                   int D, float eps, int dtype, int scale_dtype, int vw,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0) return cudaSuccess;
  if (dtype == 0) {
    if (vw == 4) return by_scale<float, 4>(x, scale, out, rows, D, eps, scale_dtype, s);
    if (vw == 1) return by_scale<float, 1>(x, scale, out, rows, D, eps, scale_dtype, s);
  } else if (dtype == 1) {
    if (vw == 8) return by_scale<__nv_bfloat16, 8>(x, scale, out, rows, D, eps, scale_dtype, s);
    if (vw == 1) return by_scale<__nv_bfloat16, 1>(x, scale, out, rows, D, eps, scale_dtype, s);
  }
  return cudaErrorInvalidValue;
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
