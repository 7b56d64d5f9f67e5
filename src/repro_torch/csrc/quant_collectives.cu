// Absmax quantization kernels per 128-element chunk, for Hopper: the
// quantize-dequantize round trip (qdq), the two hops of a quantized kept
// sync fused into one launch, quantize, dequantize and the fused
// dequantize-accumulate of the quantized ring reduce-scatter, and the send
// and receive sides of a quantized kept sync across ranks.
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
// device memory.  At a decode step's kept sync (2 x 3840) that is 0.02 us
// of bytes under a ~1 us launch: a lone qdq sits at the launch floor.
//
// quantized_psum (the two hops of every quantized kept sync; the TPU runs
// qdq_absmax twice there, with XLA's psum between): the shard-stacked
// payload (tp, n), bf16 or fp32, becomes qdq(sum_r qdq(x_r)) in every
// row.  Both hops chunk each row from its own element 0 with the same n,
// so chunk c covers the same elements in every row and one warp owns
// chunk c of ALL tp rows.  It streams the rows in groups of G (tp
// itself where tp is 1, 2, 4 or 8, one whole group whose loops unroll as
// a kernel for that tp alone would; else 8, so any tp >= 1 runs and a
// lane holds at most 8 x 4 floats):
// it issues the group's loads of its
// 4-element slices together (one 16- or 8-byte access per row where
// rows are 4-aligned), then runs hop 1 on each row of the group (its
// own absmax) and adds the dequantized row into an fp32 sum from +0, one
// row at a time in row order (__fadd_rn(acc, __fmul_rn(q, s)): no FMA
// contraction, so it equals the plain version's row-by-row adds at
// every tp).  Then hop 2 on the sum, one rounding to the payload's type,
// and the store into all tp rows.  Nothing between the hops touches
// device memory, and the cast, the sum, the broadcast copy and both qdq
// launches of the unfused chain become one launch.
// Bound: bytes (tp*n elements read and written).
//
// quantize (replaces quant_collectives.py::quantize_absmax, _quant_kernel)
// has qdq's layout and arithmetic but stores the int8 code and, from lane
// 0, the chunk's fp32 scale: ~5 bytes per element, memory-bound.
// dequantize (dequantize_absmax, _dequant_kernel) walks the chunks in a
// grid-stride loop, one warp a chunk: row and chunk come from the warp's
// chunk index, lane 0 loads the scale once and shuffles it to the warp,
// and each lane makes one 4-byte load of 4 codes and one 16-byte store of
// 4 floats (a scalar lane path where rows are not 4-aligned); 5 bytes per
// element, memory-bound.  dequant-accumulate (dequant_accum_absmax,
// _dequant_accum_kernel) is elementwise, one element per thread, the
// scale read through the cache: 9 bytes per element.  It writes acc + q*s
// as __fadd_rn(acc, __fmul_rn(q, s)) so nvcc cannot contract it into an
// FMA: it then equals PyTorch's two-op plain version bit for bit (the TPU
// kernel contracts it and is 1 ulp off its oracle).
//
// The quantized kept sync across ranks (the shard backend, one shard a
// rank) is two launches and one all-gather: the send side redesigns B4
// (quantize_absmax) for the wire, the receive side B6
// (dequant_accum_absmax) fused with hop 2.  Rank r's wire message for an
// n-element payload is one int8 row of m = pad16(n) + 4 * ceil(n/128)
// bytes:
//     [0, n)             the int8 codes, in element order
//     [n, pad16(n))      zero bytes (pad16: n rounded up to 16)
//     [pad16(n), m)      the fp32 scale of each 128-element chunk
// m and every lane's offset are multiples of 4, so in a gathered (tp, m)
// buffer each lane's 4 codes are one aligned char4 in every row.
//
// quant_message_kernel (the send): x (rows, n) bf16 or fp32, no cast
// before it, with quantized_psum_kernel's layout (one warp a chunk,
// lane l owns elements 4l .. 4l+3 in one 8- or 16-byte load where `vec`,
// a scalar path where not, warp-shuffle absmax) and B4's arithmetic;
// each lane stores its 4 codes as one char4 (an element at or past n
// loads as 0 and so codes 0, and the last chunk's warp spans pad16(n):
// it writes the pad), lane 0 the chunk's scale.  Reads n elements,
// writes m bytes: memory-bound.
// reduce_messages_kernel (the receive): the gathered (tp, m) messages ->
// y (1, n) bf16 or fp32, one warp a chunk index, for any tp >= 1.  For
// each block of up to 32 ranks lane r loads rank r's scale of the chunk
// (one load for the block, not one a rank), and the ranks stream in
// groups of G as in the fused sync: a group's char4 code loads issue
// together, then, in rank order, a shuffle hands each rank's scale to
// the warp and a lane adds __fmul_rn(q, s) into fp32 from +0 with
// __fadd_rn, which is tp B6 steps from a zero accumulator;
// then hop 2 in registers (warp absmax, qdq_one), one rounding to y's
// type and one packed store: B3 and both casts of the unfused chain.
// Reads tp * m bytes, writes n elements: memory-bound.  Both kernels are
// bit for bit the chain cast -> B4 -> gather -> B6 x tp -> B3 -> cast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;
constexpr int PER_LANE = CHUNK / 32;
constexpr int THREADS = 256;           // 8 chunks per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_absmax(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  return m;
}

// clip(rint(v / s), -L, L) * s: true division, a lone rounded multiply
__device__ __forceinline__ float qdq_one(float v, float s, float levels) {
  return __fmul_rn(fminf(fmaxf(rintf(v / s), -levels), levels), s);
}

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

// 4 consecutive elements: one 16-byte (fp32) or 8-byte (bf16) access
template <typename T>
struct alignas(4 * sizeof(T)) Pack4 {
  T v[PER_LANE];
};

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
  const float s = fmaxf(warp_absmax(mx) / levels, 1e-12f);
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int idx = c0 + lane + 32 * j;
    if (idx < n)
      y[base + idx] = fminf(fmaxf(rintf(vals[j] / s), -levels), levels) * s;
  }
}

// clip(rint(v / s), -L, L) as an int8 code (B4's arithmetic)
__device__ __forceinline__ signed char code_one(float v, float s,
                                                float levels) {
  return static_cast<signed char>(
      fminf(fmaxf(rintf(v / s), -levels), levels));
}

// Lane l's 4 elements c*128 + 4l .. 4l+3 of a row as fp32, 0 past n.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ row, int i0,
                                      int n, int vec, float* v) {
  if (vec) {
    if (i0 < n) {
      const Pack4<T> p = *reinterpret_cast<const Pack4<T>*>(row + i0);
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) v[j] = to_f(p.v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) v[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      v[j] = i0 + j < n ? to_f(row[i0 + j]) : 0.f;
  }
}

// One warp per chunk index c of all tp rows; lane l owns elements
// c*128 + 4l .. 4l+3 of every row.  The rows stream in groups of G;
// WHOLE: tp == G, one group whose loops all unroll (the small-tp path,
// as fast as one kernel a tp).  `vec`: rows 4-aligned (n % 4 == 0,
// aligned bases), so each row's 4 elements are one access.
template <typename T, int G, bool WHOLE>
__global__ void __launch_bounds__(THREADS)
quantized_psum_kernel(const T* __restrict__ x, T* __restrict__ y,
                      int tp_rows, int n, int chunks, float levels,
                      int vec) {
  const int tp = WHOLE ? G : tp_rows;
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= chunks) return;             // uniform across the warp
  const int i0 = c * CHUNK + lane * PER_LANE;

  // hop 1 on each row, summed over rows in row order from +0
  float acc[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) acc[j] = 0.f;
  for (int g0 = 0; g0 < tp; g0 += G) {
    const int rows = WHOLE ? G : min(G, tp - g0);  // uniform in the warp
    float v[G][PER_LANE];
#pragma unroll
    for (int r = 0; r < G; ++r)
      if (r < rows) load4(x + (size_t)(g0 + r) * n, i0, n, vec, v[r]);
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r < rows) {
        float mx = 0.f;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) mx = fmaxf(mx, fabsf(v[r][j]));
        const float s = fmaxf(warp_absmax(mx) / levels, 1e-12f);
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j)
          acc[j] = __fadd_rn(acc[j], qdq_one(v[r][j], s, levels));
      }
    }
  }
  // hop 2 on the sum, one rounding to T, stored into every row
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) mx = fmaxf(mx, fabsf(acc[j]));
  const float s = fmaxf(warp_absmax(mx) / levels, 1e-12f);
  Pack4<T> out;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j)
    out.v[j] = from_f<T>(qdq_one(acc[j], s, levels));
#pragma unroll
  for (int r = 0; r < tp; ++r) {
    T* row = y + (size_t)r * n;
    if (vec) {
      if (i0 < n) *reinterpret_cast<Pack4<T>*>(row + i0) = out;
    } else {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        if (i0 + j < n) row[i0 + j] = out.v[j];
    }
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
  const float s = fmaxf(warp_absmax(mx) / levels, 1e-12f);
  if (lane == 0) s_out[warp] = s;      // warp == row * cpr + chunk
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int idx = c0 + lane + 32 * j;
    if (idx < n)
      q[base + idx] = static_cast<int8_t>(
          fminf(fmaxf(rintf(vals[j] / s), -levels), levels));
  }
}

// Grid-stride over the (rows x chunks) chunk indices, one warp a chunk;
// lane l owns elements 4l .. 4l+3 of it.  `vec`: rows 4-aligned, so each
// lane reads its 4 codes in one 4-byte load and writes one float4.
__global__ void __launch_bounds__(THREADS)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
               float* __restrict__ y, int n, int chunks_per_row,
               int total_chunks, int vec) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * (THREADS / 32);
  for (int w = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
       w < total_chunks; w += stride) {   // uniform across the warp
    const int row = w / chunks_per_row;   // once a chunk, not an element
    const int i0 = (w - row * chunks_per_row) * CHUNK + lane * PER_LANE;
    const float sc = __shfl_sync(FULL, lane == 0 ? __ldg(s + w) : 0.f, 0);
    const size_t base = (size_t)row * n;
    if (vec) {
      if (i0 < n) {
        const char4 c = *reinterpret_cast<const char4*>(q + base + i0);
        *reinterpret_cast<float4*>(y + base + i0) = make_float4(
            __fmul_rn(static_cast<float>(c.x), sc),
            __fmul_rn(static_cast<float>(c.y), sc),
            __fmul_rn(static_cast<float>(c.z), sc),
            __fmul_rn(static_cast<float>(c.w), sc));
      }
    } else {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        if (i0 + j < n)
          y[base + i0 + j] =
              __fmul_rn(static_cast<float>(q[base + i0 + j]), sc);
    }
  }
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

// One warp a chunk c of row blockIdx.y; `pad` = pad16(n), `m` the
// message row's bytes.  `vec`: x's rows 4-aligned.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_message_kernel(const T* __restrict__ x, int8_t* __restrict__ msg,
                     int n, int pad, int m, int chunks, float levels,
                     int vec) {
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= chunks) return;             // uniform across the warp
  const int i0 = c * CHUNK + lane * PER_LANE;
  int8_t* out = msg + (size_t)blockIdx.y * m;
  float v[PER_LANE];
  load4(x + (size_t)blockIdx.y * n, i0, n, vec, v);
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) mx = fmaxf(mx, fabsf(v[j]));
  const float s = fmaxf(warp_absmax(mx) / levels, 1e-12f);
  if (lane == 0) reinterpret_cast<float*>(out + pad)[c] = s;
  if (i0 < pad)
    *reinterpret_cast<char4*>(out + i0) = make_char4(
        code_one(v[0], s, levels), code_one(v[1], s, levels),
        code_one(v[2], s, levels), code_one(v[3], s, levels));
}

// One warp a chunk index c of all tp messages (rows of `m` bytes), the
// ranks in blocks of 32 (a lane loads one rank's scale) and groups of G;
// WHOLE: tp == G, as in quantized_psum_kernel.  `vec`: y 4-aligned and
// n % 4 == 0.
template <typename T, int G, bool WHOLE>
__global__ void __launch_bounds__(THREADS)
reduce_messages_kernel(const int8_t* __restrict__ msg, T* __restrict__ y,
                       int tp_rows, int n, int pad, int m, int chunks,
                       float levels, int vec) {
  const int tp = WHOLE ? G : tp_rows;
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= chunks) return;             // uniform across the warp
  const int i0 = c * CHUNK + lane * PER_LANE;
  // rank order from +0; codes past n count as 0, whatever the pad holds
  float acc[PER_LANE] = {0.f, 0.f, 0.f, 0.f};
  for (int b0 = 0; b0 < tp; b0 += 32) {
    const int nb = min(32, tp - b0);   // uniform across the warp
    const float my_s =
        lane < nb ? reinterpret_cast<const float*>(
                        msg + (size_t)(b0 + lane) * m + pad)[c]
                  : 0.f;
    for (int g0 = 0; g0 < nb; g0 += G) {
      const int rows = WHOLE ? G : min(G, nb - g0);
      char4 q[G];
#pragma unroll
      for (int r = 0; r < G; ++r)
        // i0 < n: the char4 ends inside the codes' pad16(n) bytes
        q[r] = r < rows && i0 < n
                   ? *reinterpret_cast<const char4*>(
                         msg + (size_t)(b0 + g0 + r) * m + i0)
                   : make_char4(0, 0, 0, 0);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        // g0 + r < 32: G divides 32 and g0 < nb <= 32
        const float s = __shfl_sync(FULL, my_s, g0 + r);
        if (r < rows) {
          const signed char b[PER_LANE] = {q[r].x, q[r].y, q[r].z, q[r].w};
#pragma unroll
          for (int j = 0; j < PER_LANE; ++j) {
            const float qf = i0 + j < n ? static_cast<float>(b[j]) : 0.f;
            acc[j] = __fadd_rn(acc[j], __fmul_rn(qf, s));
          }
        }
      }
    }
  }
  // hop 2 on the sum, one rounding to T, one packed store
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) mx = fmaxf(mx, fabsf(acc[j]));
  const float s2 = fmaxf(warp_absmax(mx) / levels, 1e-12f);
  Pack4<T> out;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j)
    out.v[j] = from_f<T>(qdq_one(acc[j], s2, levels));
  if (vec) {
    if (i0 < n) *reinterpret_cast<Pack4<T>*>(y + i0) = out;
  } else {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (i0 + j < n) y[i0 + j] = out.v[j];
  }
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

// x, y: (tp, n), fp32 (bf16 == 0) or bf16, contiguous; any tp >= 1,
// streamed G rows at a time: tp itself where tp is 1, 2, 4 or 8 (one
// whole group), else 8 (the last group partial).  The wrapper's
// qpsum_group(tp) states the same rule for the CPU tests' emulations of
// this plan.  `blocks` blocks of `warps` warps cover the ceil(n/128)
// chunk indices; `vec`: n % 4 == 0 and both bases aligned to 4 elements.
int quantized_psum_absmax_fwd(const void* x, void* y, int tp, int n,
                              int levels, int bf16, int blocks, int warps,
                              int vec, void* stream) {
  if (tp <= 0 || n <= 0) return 0;
  if (warps <= 0 || warps > THREADS / 32 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n + CHUNK - 1) / CHUNK;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float lv = static_cast<float>(levels);
#define QPSUM_LAUNCH(T, G, W)                                            \
  quantized_psum_kernel<T, G, W><<<blocks, warps * 32, 0, st>>>(         \
      static_cast<const T*>(x), static_cast<T*>(y), tp, n, chunks, lv,   \
      vec)
#define QPSUM_CASE(T, G)                                                 \
  case G:                                                                \
    QPSUM_LAUNCH(T, G, true);                                            \
    break;
#define QPSUM_SWITCH(T)                                                  \
  switch (tp) {                                                          \
    QPSUM_CASE(T, 1) QPSUM_CASE(T, 2) QPSUM_CASE(T, 4) QPSUM_CASE(T, 8)  \
    default: QPSUM_LAUNCH(T, 8, false);                                  \
  }
  if (bf16) {
    QPSUM_SWITCH(__nv_bfloat16)
  } else {
    QPSUM_SWITCH(float)
  }
#undef QPSUM_SWITCH
#undef QPSUM_CASE
#undef QPSUM_LAUNCH
  return cudaGetLastError();
}

// q: (rows, n) int8; s: (rows, ceil(n/128)) fp32; y: (rows, n) fp32.
// `blocks` blocks of 8 warps stride over the rows * ceil(n/128) chunks;
// `vec`: n % 4 == 0, q 4-byte and y 16-byte aligned.
int dequantize_absmax_fwd(const int8_t* q, const float* s, float* y,
                          int rows, int n, int blocks, int vec,
                          void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int cpr = (n + CHUNK - 1) / CHUNK;
  dequant_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, s, y, n, cpr, rows * cpr, vec);
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

// x: (rows, n) fp32 (bf16 == 0) or bf16; msg: (rows, m) int8 messages,
// m = pad16(n) + 4 * ceil(n/128).  `blocks` x `warps` warps cover the
// chunks of a row (grid y: the rows); `vec`: x's rows 4-aligned.
int quantize_message_absmax_fwd(const void* x, int8_t* msg, int rows, int n,
                                int levels, int bf16, int blocks, int warps,
                                int vec, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 65535 || warps <= 0 || warps > THREADS / 32 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n + CHUNK - 1) / CHUNK;
  const int pad = (n + 15) / 16 * 16;
  const int m = pad + 4 * chunks;
  const dim3 grid(blocks, rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float lv = static_cast<float>(levels);
  if (bf16)
    quant_message_kernel<__nv_bfloat16><<<grid, warps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), msg, n, pad, m, chunks, lv,
        vec);
  else
    quant_message_kernel<float><<<grid, warps * 32, 0, st>>>(
        static_cast<const float*>(x), msg, n, pad, m, chunks, lv, vec);
  return cudaGetLastError();
}

// msg: (tp, m) int8, rank r's message in row r, any tp >= 1, streamed
// G ranks at a time by the fused sync's rule; y: (1, n) fp32 (bf16 == 0)
// or bf16.  `vec`: n % 4 == 0 and y 4-element aligned.
int reduce_messages_absmax_fwd(const int8_t* msg, void* y, int tp, int n,
                               int levels, int bf16, int blocks, int warps,
                               int vec, void* stream) {
  if (tp <= 0 || n <= 0) return 0;
  if (warps <= 0 || warps > THREADS / 32 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n + CHUNK - 1) / CHUNK;
  const int pad = (n + 15) / 16 * 16;
  const int m = pad + 4 * chunks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float lv = static_cast<float>(levels);
#define REDUCE_LAUNCH(T, G, W)                                           \
  reduce_messages_kernel<T, G, W><<<blocks, warps * 32, 0, st>>>(        \
      msg, static_cast<T*>(y), tp, n, pad, m, chunks, lv, vec)
#define REDUCE_CASE(T, G)                                                \
  case G:                                                                \
    REDUCE_LAUNCH(T, G, true);                                           \
    break;
#define REDUCE_SWITCH(T)                                                 \
  switch (tp) {                                                          \
    REDUCE_CASE(T, 1) REDUCE_CASE(T, 2) REDUCE_CASE(T, 4)                \
    REDUCE_CASE(T, 8)                                                    \
    default: REDUCE_LAUNCH(T, 8, false);                                 \
  }
  if (bf16) {
    REDUCE_SWITCH(__nv_bfloat16)
  } else {
    REDUCE_SWITCH(float)
  }
#undef REDUCE_SWITCH
#undef REDUCE_CASE
#undef REDUCE_LAUNCH
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
