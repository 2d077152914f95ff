// Mamba (S6) selective scan for NVIDIA Hopper (sm_90a):
//
//   h_t = exp(dt_t * A) o h_{t-1} + (dt_t * x_t) * B_t      h: [Di, N] f32
//   y_t = C_t . h_t + D o x_t
//
// per sequence b, from h_0 = 0, over every step t < S. x and y are f32 or
// bf16 (y in x's dtype, one rounding); dt, A, B, C, D and the state are f32.
// Optionally the final state h_S [Bt, Di, N] f32 is written by the same
// launch, so a prefill needs no second sequential pass to hand its state to
// decode.
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py:ssm_scan_pallas (its
// _kernel walks one time chunk of a [block_d] channel tile, the state in
// VMEM scratch carried across the sequential chunk axis of the grid). Here
// nothing carries between blocks: a block owns a run of channels of one
// sequence for the whole sequence, and its loop over time takes the place
// of the TPU's sequential grid axis.
//
// Bound, at jamba-1.5-large's prefill (Bt 2, S 1024, Di 16384, N 16, x
// bf16): the bytes are one read of x (67 MB), dt (134 MB), B, C, A, D and
// one write of y (67 MB), ~271 MB, 0.081 ms at 3.35 TB/s; the work is
// Bt S Di N = 537 M exponentials, 0.128 ms at the SFU rate (16 a clock per
// SM, 132 SMs, 1.98 GHz). So the kernel is bound by operations: the SFU's
// exponentials, and the instructions around them that the SMs must issue.
//
// What the first version lost (0.967 ms on an H100, ~20% of the issue
// rate): each step of a thread's unrolled batch sat behind its own branch,
// so the steps' chains could not overlap with ~8 warps a SM; each batch
// waited for its own x and dt loads; and the accurate expf wrapped its one
// MUFU ex2 in ~8 FMA-pipe instructions of range reduction, ~0.19 ms of FMA
// issue on its own.
//
// Design:
// * One thread a channel, holding its N <= 16 states in registers (padded
//   with A = B = C = 0 past N, which leaves h at 0 and adds nothing to y);
//   the block is held to 2 a SM of registers (176 used), so the jamba
//   prefill's 256 blocks all run in one wave. The steps of a batch overlap
//   instead (below). Two or four lanes a channel, with y's partial sums
//   shuffled together, were tried on the H100 and lost at this shape: each
//   lane repeats a step's fixed cost (the x and dt loads, the y store).
// * One MUFU and no range reduction an exponential: A' = A log2(e) is
//   rounded to f32 once per thread, and exp(dt A) = ex2.approx.ftz(dt A').
//   Against expf this adds two f32 roundings of the exponent (~|dt A| ulp of
//   the result) to ex2's own 2 ulp, which CUDA's exp2f and expf both state
//   as their bound; the decaying state does not let them grow with S.
// * The products are rounded as written (__fmul_rn / __fmaf_rn), so the
//   CPU test that emulates this order holds the kernel's arithmetic.
// * The block stages kTile steps of B_t and C_t (shared by all its
//   channels) in shared memory, zero-padded past N, and a thread reads them
//   as float4 broadcasts. The x and dt loads of the next kUnroll steps are
//   issued before this batch is computed, coalesced across the warp
//   (neighbouring threads, neighbouring channels: 128 bytes of dt a warp).
// * Any S and Di: a thread past Di computes the last channel and writes
//   the same y as its owner (so no store needs a branch, which would cut a
//   batch's steps into separate blocks of code), the ragged time tile is
//   cut. One launch a call, nothing kept between calls (CUDA-graph replay
//   is safe).
//
// C interface (bound with ctypes): ssm_scan_launch() returns the launch's
// cudaError_t; ssm_scan_error_string() names an error.

#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // threads (= channels) a block
constexpr int kMinBlocks = 2;     // blocks a SM the registers are held to
constexpr int kMaxN = 16;         // state size the registers hold
constexpr int kTile = 64;         // steps of B, C staged per pass
constexpr int kUnroll = 8;        // steps a batch; the next batch's loads fly
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 2^z in one MUFU instruction (subnormal inputs and results flush to 0)
__device__ __forceinline__ float ex2(float z) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return r;
}

// the raw x and the dt of steps t .. t + kUnroll (0 past S), one row pitch
// Di apart
template <typename T>
__device__ __forceinline__ void load_batch(const T* xp, const float* dtp, int t,
                                           int S, int Di, T* xs, float* ds) {
  const T* xq = xp + static_cast<size_t>(t) * Di;
  const float* dq = dtp + static_cast<size_t>(t) * Di;
  if (t + kUnroll <= S) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u, xq += Di, dq += Di) {
      xs[u] = *xq;
      ds[u] = *dq;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u, xq += Di, dq += Di) {
      xs[u] = t + u < S ? *xq : from_f<T>(0.0f);
      ds[u] = t + u < S ? *dq : 0.0f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ D,
                T* __restrict__ y, float* __restrict__ h_out, int S, int Di, int N) {
  __shared__ __align__(16) float sB[kTile * kMaxN];
  __shared__ __align__(16) float sC[kTile * kMaxN];
  const int d = blockIdx.x * kThreads + threadIdx.x;
  // a thread past Di computes the last channel and stores its values, which
  // equal that channel's own
  const int dc = d < Di ? d : Di - 1;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * S;   // this sequence's first step

  float a[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a[n] = n < N ? __fmul_rn(A[static_cast<size_t>(dc) * N + n], kLog2e) : 0.0f;
    h[n] = 0.0f;
  }
  const float Dd = D[dc];
  const T* xp = x + row0 * Di + dc;
  const float* dtp = dt + row0 * Di + dc;
  T* yp = y + row0 * Di + dc;

  // one step tt of the staged tile t0: every state, then y
  int t0 = 0;
  auto step = [&](int tt, T xraw, float dtv) {
    const float xv = to_f(xraw);
    const float dx = __fmul_rn(dtv, xv);
    float b[kMaxN], c[kMaxN];
#pragma unroll
    for (int q = 0; q < kMaxN / 4; ++q) {
      const float4 bq = reinterpret_cast<const float4*>(sB + tt * kMaxN)[q];
      const float4 cq = reinterpret_cast<const float4*>(sC + tt * kMaxN)[q];
      b[4 * q] = bq.x; b[4 * q + 1] = bq.y; b[4 * q + 2] = bq.z; b[4 * q + 3] = bq.w;
      c[4 * q] = cq.x; c[4 * q + 1] = cq.y; c[4 * q + 2] = cq.z; c[4 * q + 3] = cq.w;
    }
    float acc = 0.0f;                // C . h, in state order
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      const float e = ex2(__fmul_rn(dtv, a[n]));
      h[n] = __fmaf_rn(e, h[n], __fmul_rn(dx, b[n]));
      acc = n == 0 ? __fmul_rn(h[n], c[n]) : __fmaf_rn(h[n], c[n], acc);
    }
    yp[static_cast<size_t>(t0 + tt) * Di] = from_f<T>(__fmaf_rn(Dd, xv, acc));
  };

  T xn[kUnroll];
  float dn[kUnroll];
  load_batch(xp, dtp, 0, S, Di, xn, dn);
  for (; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    __syncthreads();                 // the previous tile's B, C are read
    for (int i = threadIdx.x; i < kTile * kMaxN; i += kThreads) {
      const int tt = i / kMaxN;
      const int n = i % kMaxN;
      const bool in = tt < nt && n < N;
      const size_t src = (row0 + t0 + tt) * N + n;
      sB[i] = in ? Bm[src] : 0.0f;
      sC[i] = in ? Cm[src] : 0.0f;
    }
    __syncthreads();

    for (int u0 = 0; u0 < nt; u0 += kUnroll) {
      T xs[kUnroll];
      float ds[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xs[u] = xn[u];
        ds[u] = dn[u];
      }
      load_batch(xp, dtp, t0 + u0 + kUnroll, S, Di, xn, dn);
      if (u0 + kUnroll <= nt) {      // a whole batch: one block of code, so
#pragma unroll                       // the steps' instructions can interleave
        for (int u = 0; u < kUnroll; ++u) step(u0 + u, xs[u], ds[u]);
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (u0 + u < nt) step(u0 + u, xs[u], ds[u]);
        }
      }
    }
  }

  if (h_out != nullptr && d < Di) {
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
  if (dtype == 0) {
    return launch<float>(x, dtf, Af, Bf, Cf, Df, y, hf, Bt, S, Di, N, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dtf, Af, Bf, Cf, Df, y, hf, Bt, S, Di, N, s);
  }
  return cudaErrorInvalidValue;
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
