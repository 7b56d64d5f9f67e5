// Paged causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// paged_flash_attention (body _paged_flash_kernel).  On the TPU the grid is
// (slot, logical page) with pages minor and sequential: the page table is
// scalar-prefetched so each BlockSpec DMA fetches the one physical page it
// needs, and (m, l, acc) stay in VMEM scratch across the page steps.  Blocks
// on a GPU run in no order, so here ONE thread block owns (row r of the
// shard-folded batch, kv head h, a tile of up to 32 of the g*C query rows
// that share head h) and loops over the keys itself: it reads page_table[b,
// j] from device memory, stages up to 32 keys of K and V (from one or more
// pages) in shared memory as fp32, and keeps m, l and acc in fp32
// registers, 4 threads per query row with shuffle reductions (the layout of
// flash_attention.cu).
//
// Layout: q and out (tp, B, C, Hq, D) contiguous, shard-folded into rows
// r = shard * B + b; pools (tp, P+1, ps, Hkv, D) where only each shard's
// (P+1, ps, Hkv, D) block must be contiguous -- the shard stride is an
// argument, so the pools can be one layer of a (tp, layers, P+1, ps, Hkv, D)
// segment leaf, read in place.  Row r reads table row b = r % B, pos[b], and
// the pools of shard r / B.  Query row i of slot b sits at absolute position
// pos[b] + i and sees logical key j*ps + t when that is <= its position and
// table[b, j] >= 0.  Entries of -1 contribute exactly 0; entries must
// otherwise lie in [0, P].  A fully masked row divides by the 1e-20 guard
// and comes out 0, not NaN.  fp32 math throughout, output in q's dtype.
//
// What bounds it: decode (C=1) at batch 4 does ~4*g flops per K/V element
// it reads, far below the card's ~295 flop/byte line, so the bytes of the
// visible K/V bound it.  The design reads each visible K/V row once per
// (row, head, query tile), never builds a contiguous view, and moves no
// bytes for pages that are unallocated (-1) or past the last causally
// visible key: a key tile whose pages are all -1 is skipped whole.  That
// skipping is numerically identical to the reference's masking, where those
// probabilities are exactly 0.
//
// Left for a later PR: split-K over pages (flash-decoding), so that a
// batch-4 decode fills more than a handful of the 132 SMs; cp.async / TMA
// double-buffering of the next pages behind the current tile's math; and
// mma / wgmma tensor-core tiles for the C > 1 suffix prefill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;                 // query rows per block
constexpr int BK = 32;                 // logical keys per tile
constexpr int TPR = 4;                 // threads per query row
constexpr int THREADS = BQ * TPR;      // 128
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);            // round to nearest even
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                 const T* __restrict__ vpool, const int* __restrict__ table,
                 const int* __restrict__ pos, T* __restrict__ o, int batch,
                 int c, int hq, int hkv, int ps, int n,
                 long long pool_stride, float scale) {
  constexpr int LD = D + 1;            // +1 float: no bank conflicts
  constexpr int PJ = BK / TPR;         // score columns per thread
  constexpr int AJ = D / TPR;          // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // BQ x LD
  float* ks = qs + BQ * LD;            // BK x LD
  float* vs = ks + BK * LD;            // BK x LD
  float* pr = vs + BK * LD;            // BQ x (BK + 1) probabilities
  __shared__ long long koff[BK];       // tile key's row offset, -1 = masked

  const int g = hq / hkv;
  const int rows = g * c;              // query rows that share kv head h
  const int x0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int r = blockIdx.z;            // shard * batch + b
  const int shard = r / batch;
  const int b = r % batch;
  const int tid = threadIdx.x;
  const int lr = tid / TPR;            // this thread's query in the tile
  const int tq = tid % TPR;            // its quarter of the columns
  const int x = x0 + lr;               // chunk row x / g, q head h*g + x % g
  const bool live = x < rows;
  const int ci = live ? x / g : 0;
  const int gi = live ? x % g : 0;
  const int p0 = pos[b];
  const int qpos = p0 + ci;

  const T* qg = q + (size_t)r * c * hq * D;
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, cc = i % D;
    const int xx = x0 + rr;
    float val = 0.f;
    if (xx < rows) {
      val = to_f(qg[((size_t)(xx / g) * hq + h * g + xx % g) * D + cc]);
    }
    qs[rr * LD + cc] = val;
  }

  float acc[AJ];
#pragma unroll
  for (int j = 0; j < AJ; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;

  // keys past the tile's last query position (or the table's width) are
  // never visible: the loop stops there
  const int last = min(x0 + BQ, rows) - 1;
  const int n_keys = min(n * ps, p0 + last / g + 1);
  const int* trow = table + (size_t)b * n;
  const T* kbase = kpool + shard * pool_stride;
  const T* vbase = vpool + shard * pool_stride;

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();                   // previous tile consumed
    int mine = 0;
    if (tid < BK) {
      const int kk = k0 + tid;
      long long off = -1;
      if (kk < n_keys) {
        const int phys = trow[kk / ps];
        if (phys >= 0) off = (((long long)phys * ps + kk % ps) * hkv + h) * D;
      }
      koff[tid] = off;
      mine = off >= 0;
    }
    // a tile of unallocated pages moves no bytes and does no math
    if (!__syncthreads_or(mine)) continue;
    for (int i = tid; i < BK * D; i += THREADS) {
      const int rr = i / D, cc = i % D;
      const long long off = koff[rr];
      ks[rr * LD + cc] = off >= 0 ? to_f(kbase[off + cc]) : 0.f;
      vs[rr * LD + cc] = off >= 0 ? to_f(vbase[off + cc]) : 0.f;
    }
    __syncthreads();

    float sc[PJ];
    bool ok[PJ];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int col = tq + TPR * j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qs[lr * LD + d] * ks[col * LD + d];
      ok[j] = live && koff[col] >= 0 && k0 + col <= qpos;
      sc[j] = ok[j] ? dot * scale : NEG_INF;
      mx = fmaxf(mx, sc[j]);
    }
    // the 4 threads of a query row are neighbouring lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const float p = ok[j] ? expf(sc[j] - m_new) : 0.f;
      pr[lr * (BK + 1) + tq + TPR * j] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    const float corr = expf(m - m_new);
    l = l * corr + rs;
    m = m_new;
    __syncwarp();                      // the row's probabilities are in pr
#pragma unroll
    for (int j = 0; j < AJ; ++j) {
      const int d = tq + TPR * j;
      float a = acc[j] * corr;
#pragma unroll 8
      for (int col = 0; col < BK; ++col) {
        a += pr[lr * (BK + 1) + col] * vs[col * LD + d];
      }
      acc[j] = a;
    }
  }

  if (live) {
    const float denom = fmaxf(l, 1e-20f);
    T* og = o + (((size_t)r * c + ci) * hq + h * g + gi) * D;
#pragma unroll
    for (int j = 0; j < AJ; ++j) store(&og[tq + TPR * j], acc[j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* table, const int* pos, void* o, int tp,
                   int batch, int c, int hq, int hkv, int ps, int n,
                   long long pool_stride, float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int g = hq / hkv;
  dim3 grid((g * c + BQ - 1) / BQ, hkv, tp * batch);
  paged_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, pos, static_cast<T*>(o), batch, c, hq,
      hkv, ps, n, pool_stride, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* table, const int* pos, void* o, int tp,
                     int batch, int c, int hq, int hkv, int d, int ps, int n,
                     long long pool_stride, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, table, pos, o, tp, batch, c, hq, hkv, ps,
                           n, pool_stride, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, table, pos, o, tp, batch, c, hq, hkv, ps,
                           n, pool_stride, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, table, pos, o, tp, batch, c, hq, hkv, ps,
                           n, pool_stride, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, table, pos, o, tp, batch, c, hq, hkv,
                            ps, n, pool_stride, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// table (B, n) and pos (B,) int32 on the device; pool_stride is the
// element stride between shards of the pools; is_bf16: 1 for bfloat16
// tensors, 0 for float32.  Returns the CUDA error of the launch (0 =
// launched).
int paged_attention_fwd(const void* q, const void* k, const void* v,
                        const void* table, const void* pos, void* o, int tp,
                        int batch, int c, int hq, int hkv, int d, int ps,
                        int n, long long pool_stride, float scale,
                        int is_bf16, void* stream) {
  if (tp <= 0 || batch <= 0 || c <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv || ps <= 0 || n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos);
  return is_bf16
             ? dispatch<__nv_bfloat16>(q, k, v, t, p, o, tp, batch, c, hq,
                                       hkv, d, ps, n, pool_stride, scale, st)
             : dispatch<float>(q, k, v, t, p, o, tp, batch, c, hq, hkv, d, ps,
                               n, pool_stride, scale, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
