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
// (~1 flop per byte). Design: a row belongs to tpr threads, a warp (tpr =
// 32, eight rows a block of 256) or a block of tpr <= 256 threads (wide
// rows, and rows of a decode step, where one 16-byte load a thread keeps the
// latency chain short). Thread t of a row holds its NV 16-byte vectors
// (columns (i * tpr + t) * VW, i < NV; 4 f32 or 8 bf16 values, or scalars
// when D or a pointer does not allow 16 bytes) in registers from the load to
// the store, so x is read once; the scale of those columns is loaded once,
// as vectors, before the row loop. Squares are summed in f32 per thread, by
// a warp's shuffle tree, then (tpr > 32) across the warps in shared memory
// in warp order. Rows are walked grid-stride; the next row's loads are
// issued before the current row's stores. Columns past NV * tpr * VW (only
// rows wider than the compile-time chunk counts cover: more than 2048
// vectors) are read again for the store.
//
// C interface (bound with ctypes): rmsnorm_launch() returns the launch's
// cudaError_t; rmsnorm_floor_launch() launches an empty kernel of the same
// grid and block (the launch floor a timing compares with);
// rmsnorm_error_string() names an error.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;         // threads a block in warp mode; the most a row takes

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

template <typename T, int VW, int NV>
__device__ __forceinline__ void load_row(Vec<T, VW> (&xv)[NV], const T* __restrict__ xr, int D,
                                         int tpr, int t) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * tpr + t) * VW;
    if (c < D) xv[i] = *reinterpret_cast<const Vec<T, VW>*>(xr + c);
  }
}

template <typename T, typename S, int VW, int NV>
__global__ void __launch_bounds__(kBlock)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
               long long rows, int D, float eps, int tpr) {
  __shared__ float part[2][kBlock / 32];
  const int tid = static_cast<int>(threadIdx.x);
  const int t = tid % tpr;
  const int groups = static_cast<int>(blockDim.x) / tpr;
  const long long stride = static_cast<long long>(gridDim.x) * groups;
  long long row = static_cast<long long>(blockIdx.x) * groups + tid / tpr;
  const int held = NV * tpr * VW;                         // columns kept in registers

  Vec<S, VW> sv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * tpr + t) * VW;
    if (c < D) sv[i] = *reinterpret_cast<const Vec<S, VW>*>(scale + c);
  }
  Vec<T, VW> xv[NV];
  if (row < rows) load_row<T, VW, NV>(xv, x + row * D, D, tpr, t);
  int parity = 0;
  // in block mode (tpr > 32) every thread of the block walks the same rows,
  // so the barrier below is reached by all
  while (row < rows) {
    const T* xr = x + row * D;
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((i * tpr + t) * VW < D) {
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float f = to_f(xv[i].v[e]);
          ss = fmaf(f, f, ss);
        }
      }
    }
    for (int c = held + t * VW; c < D; c += tpr * VW) {   // rows past the registers
      const Vec<T, VW> a = *reinterpret_cast<const Vec<T, VW>*>(xr + c);
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float f = to_f(a.v[e]);
        ss = fmaf(f, f, ss);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (tpr > 32) {
      if ((tid & 31) == 0) part[parity][tid >> 5] = ss;
      __syncthreads();
      ss = part[parity][0];
      for (int w = 1; w < tpr / 32; ++w) ss += part[parity][w];
      parity ^= 1;
    }
    const float r = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);   // IEEE sqrt and divide

    const long long next = row + stride;
    Vec<T, VW> xn[NV];
    if (next < rows) load_row<T, VW, NV>(xn, x + next * D, D, tpr, t);
    T* orow = out + row * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * tpr + t) * VW;
      if (c < D) {
        Vec<T, VW> o;
#pragma unroll
        for (int e = 0; e < VW; ++e) o.v[e] = from_f<T>((to_f(xv[i].v[e]) * r) * to_f(sv[i].v[e]));
        *reinterpret_cast<Vec<T, VW>*>(orow + c) = o;
      }
    }
    for (int c = held + t * VW; c < D; c += tpr * VW) {
      const Vec<T, VW> a = *reinterpret_cast<const Vec<T, VW>*>(xr + c);
      const Vec<S, VW> b = *reinterpret_cast<const Vec<S, VW>*>(scale + c);
      Vec<T, VW> o;
#pragma unroll
      for (int e = 0; e < VW; ++e) o.v[e] = from_f<T>((to_f(a.v[e]) * r) * to_f(b.v[e]));
      *reinterpret_cast<Vec<T, VW>*>(orow + c) = o;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) xv[i] = xn[i];
    row = next;
  }
}

__global__ void rmsnorm_floor_kernel() {}

template <typename T, typename S, int VW>
cudaError_t launch_nv(const void* x, const void* scale, void* out, long long rows, int D,
                      float eps, int tpr, int nv, unsigned grid, int block, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* op = static_cast<T*>(out);
  switch (nv) {
    case 1: rmsnorm_kernel<T, S, VW, 1><<<grid, block, 0, s>>>(xp, sp, op, rows, D, eps, tpr); break;
    case 2: rmsnorm_kernel<T, S, VW, 2><<<grid, block, 0, s>>>(xp, sp, op, rows, D, eps, tpr); break;
    case 4: rmsnorm_kernel<T, S, VW, 4><<<grid, block, 0, s>>>(xp, sp, op, rows, D, eps, tpr); break;
    case 8: rmsnorm_kernel<T, S, VW, 8><<<grid, block, 0, s>>>(xp, sp, op, rows, D, eps, tpr); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int VW>
cudaError_t by_scale(const void* x, const void* scale, void* out, long long rows, int D,
                     float eps, int scale_dtype, int tpr, int nv, unsigned grid, int block,
                     cudaStream_t s) {
  if (scale_dtype == 0)
    return launch_nv<T, float, VW>(x, scale, out, rows, D, eps, tpr, nv, grid, block, s);
  if (scale_dtype == 1)
    return launch_nv<T, __nv_bfloat16, VW>(x, scale, out, rows, D, eps, tpr, nv, grid, block, s);
  return cudaErrorInvalidValue;
}

int checked_launch(const void* x, const void* scale, void* out, long long rows, int D,
                   float eps, int dtype, int scale_dtype, int vw, int tpr, int nv, int grid,
                   bool floor, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0) return cudaSuccess;
  if (tpr < 32 || tpr > kBlock || tpr % 32 || grid <= 0) return cudaErrorInvalidValue;
  const int block = tpr == 32 ? kBlock : tpr;
  if (floor) {
    rmsnorm_floor_kernel<<<static_cast<unsigned>(grid), block, 0, s>>>();
    return cudaGetLastError();
  }
  const unsigned g = static_cast<unsigned>(grid);
  if (dtype == 0) {
    if (vw == 4) return by_scale<float, 4>(x, scale, out, rows, D, eps, scale_dtype, tpr, nv, g, block, s);
    if (vw == 1) return by_scale<float, 1>(x, scale, out, rows, D, eps, scale_dtype, tpr, nv, g, block, s);
  } else if (dtype == 1) {
    if (vw == 8)
      return by_scale<__nv_bfloat16, 8>(x, scale, out, rows, D, eps, scale_dtype, tpr, nv, g, block, s);
    if (vw == 1)
      return by_scale<__nv_bfloat16, 1>(x, scale, out, rows, D, eps, scale_dtype, tpr, nv, g, block, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, out: [rows, D] row-major, dtype 0 float32 / 1 bfloat16 (the same for
// both); scale: [D], scale_dtype 0 / 1. vw: elements per load (f32: 4 or
// 1, bf16: 8 or 1); the caller picks 1 unless D and every pointer allow
// the 16-byte load. tpr: threads a row (32: a warp, eight rows a block of
// 256; 64-256 in steps of 32: a block); nv in {1, 2, 4, 8}: vectors a
// thread holds; grid: blocks (rows are walked grid-stride).
int rmsnorm_launch(const void* x, const void* scale, void* out, long long rows, int D,
                   float eps, int dtype, int scale_dtype, int vw, int tpr, int nv, int grid,
                   void* stream) {
  return checked_launch(x, scale, out, rows, D, eps, dtype, scale_dtype, vw, tpr, nv, grid,
                        false, stream);
}

// The same arguments; launches an empty kernel of the same grid and block.
int rmsnorm_floor_launch(const void* x, const void* scale, void* out, long long rows, int D,
                         float eps, int dtype, int scale_dtype, int vw, int tpr, int nv,
                         int grid, void* stream) {
  return checked_launch(x, scale, out, rows, D, eps, dtype, scale_dtype, vw, tpr, nv, grid,
                        true, stream);
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
