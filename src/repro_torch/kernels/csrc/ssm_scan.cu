// Mamba (S6) selective scan for NVIDIA Hopper (sm_90a):
//
//   h_t = exp(dt_t * A) o h_{t-1} + (dt_t * x_t) * B_t      h: [Di, N] f32
//   y_t = C_t . h_t + D o x_t
//
// per sequence b, from h_0 = 0, over every step t < S. x and y are f32 or
// bf16 (y in x's dtype, one rounding); dt, A, B, C, D and the state are f32.
// Optionally the final state h_S [Bt, Di, N] f32 is written, so a prefill
// needs no second sequential pass to hand its state to decode.
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py:ssm_scan_pallas (its
// _kernel walks one time chunk of a [block_d] channel tile, the state in
// VMEM scratch carried across the sequential chunk axis of the grid). Here
// nothing carries between blocks: one block owns 128 channels of one
// sequence for the whole sequence, and its loop over time takes the place
// of the TPU's sequential grid axis.
//
// Bound, at jamba-1.5-large's prefill (Bt 2, S 1024, Di 16384, N 16, x
// bf16): the bytes are one read of x (67 MB), dt (134 MB), B, C, A, D and
// one write of y (67 MB), ~271 MB, 0.081 ms at 3.35 TB/s; the work is
// Bt S Di N = 537 M exponentials, 0.128 ms at the SFU rate (16 a clock per
// SM, 132 SMs, 1.98 GHz). expf here is the accurate one (a range reduction
// on the FMA pipe around one ex2.approx), plus 3 FMAs per (t, d, n), so the
// kernel is bound by operations (instructions), not bytes.
//
// Design: one thread owns channel d of sequence b and keeps A[d, :] and
// h[d, :] (N <= 16, unrolled, so both stay in registers). The block stages
// a tile of kTile steps of B_t and C_t (shared by all its channels) in
// shared memory and reads them as broadcasts. The x and dt loads of kUnroll
// steps are issued together before those steps are computed, coalesced
// across the warp (neighbouring threads, neighbouring channels), so that
// their device-memory latency overlaps instead of stalling each step. Any
// S and Di: the ragged channel tail is masked, the ragged time tile cut.
//
// C interface (bound with ctypes): ssm_scan_launch() returns the launch's
// cudaError_t; ssm_scan_error_string() names it.

#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // channels per block
constexpr int kMaxN = 16;         // state size the registers hold
constexpr int kTile = 64;         // steps of B, C staged per pass
constexpr int kUnroll = 8;        // steps whose x, dt loads are in flight together

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ D,
                T* __restrict__ y, float* __restrict__ h_out, int S, int Di, int N) {
  __shared__ float sB[kTile * kMaxN];
  __shared__ float sC[kTile * kMaxN];
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < Di;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * S;   // this sequence's first step

  float a[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a[n] = (active && n < N) ? A[static_cast<size_t>(d) * N + n] : 0.0f;
    h[n] = 0.0f;
  }
  const float Dd = active ? D[d] : 0.0f;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    __syncthreads();                 // the previous tile's B, C are read
    const float* Bsrc = Bm + (row0 + t0) * N;
    const float* Csrc = Cm + (row0 + t0) * N;
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const int tt = i / N;
      const int n = i - tt * N;
      sB[tt * kMaxN + n] = Bsrc[i];
      sC[tt * kMaxN + n] = Csrc[i];
    }
    __syncthreads();
    if (!active) continue;           // every thread still meets each barrier

    for (int u0 = 0; u0 < nt; u0 += kUnroll) {
      float xs[kUnroll], ds[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xs[u] = 0.0f;
        ds[u] = 0.0f;
        if (u0 + u < nt) {
          const size_t off = (row0 + t0 + u0 + u) * Di + d;
          xs[u] = to_f(x[off]);
          ds[u] = dt[off];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int tt = u0 + u;
        if (tt < nt) {
          const float dx = ds[u] * xs[u];
          const float* bt = sB + tt * kMaxN;
          const float* ct = sC + tt * kMaxN;
          float acc = 0.0f;
#pragma unroll
          for (int n = 0; n < kMaxN; ++n) {
            if (n < N) {
              h[n] = expf(ds[u] * a[n]) * h[n] + dx * bt[n];
              acc += h[n] * ct[n];
            }
          }
          y[(row0 + t0 + tt) * Di + d] = from_f<T>(acc + Dd * xs[u]);
        }
      }
    }
  }

  if (h_out != nullptr && active) {
    float* hd = h_out + (static_cast<size_t>(blockIdx.y) * Di + d) * N;
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      if (n < N) hd[n] = h[n];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const float* B,
                   const float* C, const float* D, void* y, float* h_out, int Bt,
                   int S, int Di, int N, cudaStream_t s) {
  const dim3 grid((Di + kThreads - 1) / kThreads, Bt);
  ssm_scan_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), dt, A, B, C, D, static_cast<T*>(y), h_out, S, Di, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: [Bt, S, Di] row-major, dtype 0 float32 / 1 bfloat16; dt [Bt, S, Di],
// A [Di, N], B and C [Bt, S, N], D [Di]: float32, contiguous. h_out: null,
// or [Bt, Di, N] float32 for the final state. 1 <= N <= 16, Bt <= 65535.
int ssm_scan_launch(const void* x, const void* dt, const void* A, const void* B,
                    const void* C, const void* D, void* y, void* h_out, int Bt,
                    int S, int Di, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > kMaxN || Bt < 0 || Bt > 65535 || S < 0 || Di < 0) {
    return cudaErrorInvalidValue;
  }
  if (Bt == 0 || Di == 0) return cudaSuccess;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  const float* Cf = static_cast<const float*>(C);
  const float* Df = static_cast<const float*>(D);
  float* hf = static_cast<float*>(h_out);
  if (dtype == 0) return launch<float>(x, dtf, Af, Bf, Cf, Df, y, hf, Bt, S, Di, N, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dtf, Af, Bf, Cf, Df, y, hf, Bt, S, Di, N, s);
  }
  return cudaErrorInvalidValue;
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
