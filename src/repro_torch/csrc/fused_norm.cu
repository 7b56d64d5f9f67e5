// Fused residual add + RMSNorm for Hopper.
//
// Replaces the TPU kernel repro/kernels/fused_norm.py::fused_residual_rmsnorm
// (body _kernel): there a grid step takes (block_rows, d) tiles of x and r
// into VMEM and writes both outputs.  Here ONE block owns one row:
//     s = x + r                      (fp32)
//     y = s * rsqrt(mean(s^2) + eps) * w
// and it writes y and s in x's dtype (fp32 or bf16), with fp32 math.  d is
// any width (960 for SmolLM-360M, not a power of two), so the threads walk
// the row with a stride, sum s^2 in fp32, and reduce with warp shuffles and
// then across warps through shared memory.  The second pass reads x and r
// again (L1/L2-resident: a row is a few KB) rather than keeping s in
// registers for an unknown d.
//
// What bounds it: 2 reads + 2 writes of (T, d) against ~6 flops per
// element, so device-memory bandwidth.  One pass over device memory in the
// sense that matters: the sum never makes a round trip through it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, typename W>
__global__ void __launch_bounds__(THREADS)
fused_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                     const W* __restrict__ w, T* __restrict__ y,
                     T* __restrict__ s_out, int d, float eps) {
  __shared__ float partial[THREADS / 32];
  const size_t base = (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    const float s = __fadd_rn(to_f(x[base + j]), to_f(r[base + j]));
    s_out[base + j] = from_f<T>(s);
    ss = __fmaf_rn(s, s, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = threadIdx.x < THREADS / 32 ? partial[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (threadIdx.x == 0) partial[0] = ss;
  }
  __syncthreads();
  const float inv = rsqrtf(partial[0] / static_cast<float>(d) + eps);
  for (int j = threadIdx.x; j < d; j += THREADS) {
    const float s = __fadd_rn(to_f(x[base + j]), to_f(r[base + j]));
    y[base + j] = from_f<T>(__fmul_rn(__fmul_rn(s, inv), to_f(w[j])));
  }
}

template <typename T, typename W>
int launch(const void* x, const void* r, const void* w, void* y, void* s,
           int rows, int d, float eps, cudaStream_t stream) {
  fused_rmsnorm_kernel<T, W><<<rows, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const W*>(w), static_cast<T*>(y), static_cast<T*>(s), d,
      eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, r, y, s: (rows, d) contiguous, fp32 or (x_bf16) bf16; w: (d,) fp32
// or (w_bf16) bf16.  Returns the CUDA error of the launch.
int fused_residual_rmsnorm_fwd(const void* x, const void* r, const void* w,
                               void* y, void* s, int rows, int d, float eps,
                               int x_bf16, int w_bf16, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, y, s, rows, d, eps,
                                                st);
  if (x_bf16) return launch<__nv_bfloat16, float>(x, r, w, y, s, rows, d, eps,
                                                  st);
  if (w_bf16) return launch<float, __nv_bfloat16>(x, r, w, y, s, rows, d, eps,
                                                  st);
  return launch<float, float>(x, r, w, y, s, rows, d, eps, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
