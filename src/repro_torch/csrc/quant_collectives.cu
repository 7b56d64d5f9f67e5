// Absmax quantization kernels per 128-element chunk, for Hopper: the
// quantize-dequantize round trip (qdq), quantize, dequantize and the fused
// dequantize-accumulate of the quantized ring reduce-scatter.
//
// qdq replaces the TPU kernel repro/kernels/quant_collectives.py::qdq_absmax
// (body _qdq_kernel): there a grid step takes a (block_rows, 128) tile of
// lane rows into VMEM.  Here ONE warp owns one chunk: each lane loads 4
// elements (coalesced, stride 32), max|x| is reduced with __shfl_xor_sync,
// and the lane writes its 4 outputs
//     s = max(max|x| / L, 1e-12),  y = clip(rint(x / s), -L, L) * s
// with L = 127 (quant8) or 7 (quant4).  Matches the reference oracle
// bit for bit: true IEEE division (no reciprocal), round half to even
// (rintf), and the file is built without --use_fast_math; the final q*s
// is a lone multiply, so there is nothing to contract into an FMA.
//
// The input is a (rows, n) fp32 matrix and chunking restarts at every row
// (each row is one TP shard's payload, chunked from 0 as the reference
// does per shard); the ragged tail chunk of a row is masked, never padded
// in memory.
//
// What bounds it: 8 bytes per element (read + write) against ~4 flops, so
// it is bound by device-memory bandwidth; one pass, no intermediate in
// device memory.
//
// quantize (replaces quant_collectives.py::quantize_absmax, _quant_kernel)
// has qdq's layout and arithmetic but stores the int8 code and, from lane
// 0, the chunk's fp32 scale: ~5 bytes per element, memory-bound.  dequantize
// (dequantize_absmax, _dequant_kernel) and dequant-accumulate
// (dequant_accum_absmax, _dequant_accum_kernel) are elementwise, one
// element per thread, the scale read through the cache; both are bound by
// device-memory bandwidth (5 and 9 bytes per element).  Dequant-accumulate
// writes acc + q*s as __fadd_rn(acc, __fmul_rn(q, s)) so nvcc cannot
// contract it into an FMA: it then equals PyTorch's two-op plain version
// bit for bit (the TPU kernel contracts it and is 1 ulp off its oracle).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;
constexpr int PER_LANE = CHUNK / 32;
constexpr int THREADS = 256;           // 8 chunks per block

__global__ void __launch_bounds__(THREADS)
qdq_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
           int chunks_per_row, int total_chunks, float levels) {
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= total_chunks) return;    // uniform across the warp
  const int row = warp / chunks_per_row;
  const int c0 = (warp % chunks_per_row) * CHUNK;
  const size_t base = (size_t)row * n;

  float vals[PER_LANE];
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int idx = c0 + lane + 32 * j;
    vals[j] = idx < n ? x[base + idx] : 0.f;
    mx = fmaxf(mx, fabsf(vals[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float s = fmaxf(mx / levels, 1e-12f);
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int idx = c0 + lane + 32 * j;
    if (idx < n)
      y[base + idx] = fminf(fmaxf(rintf(vals[j] / s), -levels), levels) * s;
  }
}

// One warp per chunk, as qdq_kernel; codes to q, the scale to s.
__global__ void __launch_bounds__(THREADS)
quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ s_out, int n, int chunks_per_row,
             int total_chunks, float levels) {
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= total_chunks) return;    // uniform across the warp
  const int row = warp / chunks_per_row;
  const int c0 = (warp % chunks_per_row) * CHUNK;
  const size_t base = (size_t)row * n;

  float vals[PER_LANE];
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int idx = c0 + lane + 32 * j;
    vals[j] = idx < n ? x[base + idx] : 0.f;
    mx = fmaxf(mx, fabsf(vals[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float s = fmaxf(mx / levels, 1e-12f);
  if (lane == 0) s_out[warp] = s;      // warp == row * cpr + chunk
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int idx = c0 + lane + 32 * j;
    if (idx < n)
      q[base + idx] = static_cast<int8_t>(
          fminf(fmaxf(rintf(vals[j] / s), -levels), levels));
  }
}

__global__ void __launch_bounds__(THREADS)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
               float* __restrict__ y, int n, int chunks_per_row,
               int total) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int row = i / n;
  const int col = i - row * n;
  y[i] = __fmul_rn(static_cast<float>(q[i]),
                   __ldg(s + row * chunks_per_row + col / CHUNK));
}

__global__ void __launch_bounds__(THREADS)
dequant_accum_kernel(const int8_t* __restrict__ q,
                     const float* __restrict__ s,
                     const float* __restrict__ acc, float* __restrict__ y,
                     int n, int chunks_per_row, int total) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int row = i / n;
  const int col = i - row * n;
  const float d = __fmul_rn(static_cast<float>(q[i]),
                            __ldg(s + row * chunks_per_row + col / CHUNK));
  y[i] = __fadd_rn(acc[i], d);
}

}  // namespace

extern "C" {

// x, y: (rows, n) fp32, contiguous.  Returns the CUDA error of the launch.
int qdq_absmax_fwd(const float* x, float* y, int rows, int n, int levels,
                   void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int cpr = (n + CHUNK - 1) / CHUNK;
  const int total = rows * cpr;
  const int blocks = (total + THREADS / 32 - 1) / (THREADS / 32);
  qdq_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n, cpr, total, static_cast<float>(levels));
  return cudaGetLastError();
}

// x: (rows, n) fp32; q: (rows, n) int8; s: (rows, ceil(n/128)) fp32.
int quantize_absmax_fwd(const float* x, int8_t* q, float* s, int rows,
                        int n, int levels, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int cpr = (n + CHUNK - 1) / CHUNK;
  const int total = rows * cpr;
  const int blocks = (total + THREADS / 32 - 1) / (THREADS / 32);
  quant_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, q, s, n, cpr, total, static_cast<float>(levels));
  return cudaGetLastError();
}

// q: (rows, n) int8; s: (rows, ceil(n/128)) fp32; y: (rows, n) fp32.
int dequantize_absmax_fwd(const int8_t* q, const float* s, float* y,
                          int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int total = rows * n;
  const int blocks = (total + THREADS - 1) / THREADS;
  dequant_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, s, y, n, (n + CHUNK - 1) / CHUNK, total);
  return cudaGetLastError();
}

// y = acc + q * s, all (rows, n) but s (rows, ceil(n/128)).
int dequant_accum_absmax_fwd(const int8_t* q, const float* s,
                             const float* acc, float* y, int rows, int n,
                             void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int total = rows * n;
  const int blocks = (total + THREADS - 1) / THREADS;
  dequant_accum_kernel<<<blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      q, s, acc, y, n, (n + CHUNK - 1) / CHUNK, total);
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
