// Paged causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// paged_flash_attention (body _paged_flash_kernel).  On the TPU the grid is
// (slot, logical page) with pages minor and sequential: the page table is
// scalar-prefetched so each BlockSpec DMA fetches the one physical page it
// needs, and (m, l, acc) stay in VMEM scratch across the page steps.  Blocks
// on a GPU run in no order and carry nothing to each other, so each block
// here reads page_table[b, j] from device memory itself.
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
// Unallocated (-1) pages and keys past the last visible position move no
// bytes; that is numerically the reference's masking, where those
// probabilities are exactly 0.
//
// Decode (C = 1), paged_decode_split_kernel + paged_decode_combine_kernel
// (flash-decoding).  What bounds it: a batch-4 decode does ~4*g flops per
// K/V element it reads, far below the card's ~295 flop/byte line, and the
// ~1 MB of visible K/V of one layer is 0.3 us at the memory rate, so the
// time is latency: how many SMs issue loads, and how many loads each has in
// flight.  One block per (row, kv head) walking the keys in turn gave 24
// blocks for 132 SMs, 3 of 32 query rows live and scalar loads: ~130 us.
// So the keys are split:
//   - the split kernel's grid is (n_splits, Hkv, tp*B), n_splits =
//     ceil(n*ps / KS) from the table's width (no host sync); each block
//     owns KS = 64 logical keys of one (row, kv head), reads their pages'
//     table entries itself, and holds the g query heads of its kv head in
//     registers, so each visible K/V row is read once;
//   - a key row is read as 16 bytes per lane (8 lanes per 64-wide bf16
//     row, 4 keys per warp load); each lane issues the table entries (the
//     first beside pos[b]) and then the K/V rows of up to 4 keys before
//     any math, so the loads of a split are in flight together; dot
//     products are reduced by
//     shuffles in the lane group, the online softmax is fp32; key groups
//     merge by shuffles, warps in shared memory, and the block writes its
//     partial (acc[D], m, l) in fp32 to scratch that the wrapper allocates;
//   - a split with no visible key (all past pos[b]) writes an empty
//     partial (m = -1e30, l = 0, acc = 0) and reads nothing; a split whose
//     pages are all -1 reads no K/V and comes out empty too;
//   - the combine kernel, one block per (row, kv head), one thread per
//     (query head, column), reads 8 partials' (m, l, acc[d]) at a time,
//     all in flight, rescales them by exp(m_i - M) (M the running max)
//     and writes acc / max(l, 1e-20) in q's dtype.
// The math stays on CUDA cores: at g*C = 3 query rows per kv head tensor
// cores buy nothing.
//
// Chunks (C > 1, the warm suffix prefill), paged_fwd_kernel: ONE thread
// block owns (row, kv head h, a tile of up to 32 of the g*C query rows that
// share h) and loops over 32-key tiles itself, staging K and V (from one or
// more pages) in shared memory as fp32, with m, l and acc in fp32
// registers, 4 threads per query row with shuffle reductions.  A key tile
// whose pages are all -1 is skipped whole.
//
// Left for later: tensor-core tiles (mma / wgmma) for the C > 1 chunks, and
// cp.async / TMA double-buffering of their pages.
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

// ---------------------------------------------------------------------------
// Decode (C = 1): split over keys, then combine
// ---------------------------------------------------------------------------

constexpr int KS = 64;                 // logical keys per split
constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int GT = 8;                  // query heads in registers per pass

// 16 bytes of a row, loaded raw, then as 4 fp32 or 8 bf16 in fp32
__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void unpack16(float (&x)[4], uint4 u) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(float (&x)[8], uint4 u) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// part (tp*B, Hkv, n_splits, g, D + 2) fp32: acc[0..D), m at D, l at D+1
template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ kpool,
                          const T* __restrict__ vpool,
                          const int* __restrict__ table,
                          const int* __restrict__ pos,
                          float* __restrict__ part, int batch, int hq,
                          int hkv, int ps, int n, long long pool_stride,
                          float scale) {
  constexpr int EPL = 16 / (int)sizeof(T);   // row elements per lane
  constexpr int LPK = D / EPL;               // lanes per key row
  constexpr int KPW = 32 / LPK;              // keys per warp load
  constexpr int STEPS = KS / (KPW * DEC_WARPS);
  constexpr int CH = STEPS < 4 ? STEPS : 4;  // loads in flight per lane
  static_assert(LPK <= 32 && STEPS % CH == 0, "tiling");
  __shared__ float red[DEC_WARPS][GT][D + 2];

  const int split = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int shard = r / batch, b = r % batch;
  const int g = hq / hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPK;          // this lane's 16 bytes of the row
  const int kslot = lane / LPK;        // its key in the warp's load
  const int k_begin = split * KS;
  const int k_max = min(k_begin + KS, n * ps);
  const int* trow = table + (size_t)b * n;
  // the first chunk's table entries are requested beside pos[b]: neither
  // waits for the other
  int phys0[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int kk = k_begin + (c * DEC_WARPS + warp) * KPW + kslot;
    phys0[c] = kk < k_max ? trow[kk / ps] : -1;
  }
  // keys past pos[b] (the query's position) or the table are invisible
  const int k_end = min(k_max, pos[b] + 1);
  float* out = part + (((size_t)r * hkv + h) * gridDim.x + split) *
                          (size_t)g * (D + 2);
  if (k_begin >= k_end) {              // nothing visible: empty partial
    for (int i = tid; i < g * (D + 2); i += DEC_THREADS)
      out[i] = i % (D + 2) == D ? NEG_INF : 0.f;
    return;
  }
  const size_t col = (size_t)h * D + sub * EPL;
  const T* kbase = kpool + shard * pool_stride + col;
  const T* vbase = vpool + shard * pool_stride + col;
  const T* qrow = q + ((size_t)r * hq + h * g) * D + sub * EPL;

  for (int j0 = 0; j0 < g; j0 += GT) {
    const int gc = min(GT, g - j0);
    float qv[GT][EPL], acc[GT][EPL], m[GT], l[GT];
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      unpack16(qv[j], j < gc ? ld16(qrow + (size_t)(j0 + j) * D)
                             : make_uint4(0, 0, 0, 0));
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[j][e] = 0.f;
      m[j] = NEG_INF;
      l[j] = 0.f;
    }
#pragma unroll
    for (int s0 = 0; s0 < STEPS; s0 += CH) {
      // CH keys' table entries, then their K/V rows, all in flight
      // before any math
      int phys[CH], kk[CH];
      uint4 kraw[CH], vraw[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        kk[c] = k_begin + ((s0 + c) * DEC_WARPS + warp) * KPW + kslot;
        phys[c] = s0 == 0 ? phys0[c] : kk[c] < k_max ? trow[kk[c] / ps] : -1;
        if (kk[c] >= k_end) phys[c] = -1;
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        kraw[c] = vraw[c] = make_uint4(0, 0, 0, 0);
        if (phys[c] >= 0) {
          const size_t off =
              ((size_t)phys[c] * ps + kk[c] % ps) * hkv * D;
          kraw[c] = ld16(kbase + off);
          vraw[c] = ld16(vbase + off);
        }
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float kx[EPL], vx[EPL];
        unpack16(kx, kraw[c]);
        unpack16(vx, vraw[c]);
#pragma unroll
        for (int j = 0; j < GT; ++j) {
          if (j < gc) {                // uniform over the block
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) dot += qv[j][e] * kx[e];
#pragma unroll
            for (int o = LPK / 2; o >= 1; o >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, o);
            if (phys[c] >= 0) {
              const float sc = dot * scale;
              const float m_new = fmaxf(m[j], sc);
              const float corr = expf(m[j] - m_new);
              const float p = expf(sc - m_new);
              l[j] = l[j] * corr + p;
#pragma unroll
              for (int e = 0; e < EPL; ++e)
                acc[j][e] = acc[j][e] * corr + p * vx[e];
              m[j] = m_new;
            }
          }
        }
      }
    }
    // merge the warp's key slots (lanes LPK, 2*LPK, ... apart); an empty
    // state (m = -1e30, l = 0) merges as a zero
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < GT; ++j) {
        if (j < gc) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[j], o);
          const float lo = __shfl_xor_sync(0xffffffffu, l[j], o);
          const float mm = fmaxf(m[j], mo);
          const float c1 = expf(m[j] - mm), c2 = expf(mo - mm);
          l[j] = l[j] * c1 + lo * c2;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const float ao = __shfl_xor_sync(0xffffffffu, acc[j][e], o);
            acc[j][e] = acc[j][e] * c1 + ao * c2;
          }
          m[j] = mm;
        }
      }
    }
    if (kslot == 0) {
#pragma unroll
      for (int j = 0; j < GT; ++j) {
        if (j < gc) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) red[warp][j][sub * EPL + e] = acc[j][e];
          if (sub == 0) {
            red[warp][j][D] = m[j];
            red[warp][j][D + 1] = l[j];
          }
        }
      }
    }
    __syncthreads();
    // merge the warps; write this split's partial for heads j0..j0+gc
    for (int i = tid; i < gc * D; i += DEC_THREADS) {
      const int j = i / D, d = i % D;
      float mm = NEG_INF;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) mm = fmaxf(mm, red[w][j][D]);
      float a = 0.f, ls = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float c = expf(red[w][j][D] - mm);
        a += c * red[w][j][d];
        ls += c * red[w][j][D + 1];
      }
      float* oj = out + (size_t)(j0 + j) * (D + 2);
      oj[d] = a;
      if (d == 0) {
        oj[D] = mm;
        oj[D + 1] = ls;
      }
    }
    __syncthreads();                   // red is free for the next heads
  }
}

constexpr int CS = 8;                  // partials a combine thread reads
                                       // per round, all in flight

template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_combine_kernel(const float* __restrict__ part,
                            T* __restrict__ o, int hq, int hkv,
                            int n_splits) {
  const int h = blockIdx.x, r = blockIdx.y;
  const int g = hq / hkv;
  const float* pr = part + ((size_t)r * hkv + h) * n_splits * (size_t)g *
                               (D + 2);
  for (int i = threadIdx.x; i < g * D; i += DEC_THREADS) {
    const int j = i / D, d = i % D;
    float mm = NEG_INF, a = 0.f, ls = 0.f;
    for (int s0 = 0; s0 < n_splits; s0 += CS) {
      float pm[CS], pl[CS], pa[CS];
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const bool ok = s0 + c < n_splits;
        const float* e = pr + ((size_t)(s0 + c) * g + j) * (D + 2);
        pm[c] = ok ? e[D] : NEG_INF;
        pl[c] = ok ? e[D + 1] : 0.f;
        pa[c] = ok ? e[d] : 0.f;
      }
      float cm = mm;
#pragma unroll
      for (int c = 0; c < CS; ++c) cm = fmaxf(cm, pm[c]);
      const float corr = expf(mm - cm);
      a *= corr;
      ls *= corr;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const float w = expf(pm[c] - cm);  // 0 for an empty partial
        a += w * pa[c];                    // unless all are empty, when
        ls += w * pl[c];                   // a and l stay 0
      }
      mm = cm;
    }
    store(&o[((size_t)r * hq + h * g + j) * D + d], a / fmaxf(ls, 1e-20f));
  }
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* table, const int* pos, float* part,
                          void* o, int tp, int batch, int hq, int hkv,
                          int ps, int n, int n_splits, long long pool_stride,
                          float scale, cudaStream_t stream) {
  dim3 grid(n_splits, hkv, tp * batch);
  paged_decode_split_kernel<T, D><<<grid, DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, pos, part, batch, hq, hkv, ps, n,
      pool_stride, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<T, D>
      <<<dim3(hkv, tp * batch), DEC_THREADS, 0, stream>>>(
          part, static_cast<T*>(o), hq, hkv, n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_decode(const void* q, const void* k, const void* v,
                            const int* table, const int* pos, float* part,
                            void* o, int tp, int batch, int hq, int hkv,
                            int d, int ps, int n, int n_splits,
                            long long pool_stride, float scale,
                            cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_decode<T, 16>(q, k, v, table, pos, part, o, tp, batch,
                                  hq, hkv, ps, n, n_splits, pool_stride,
                                  scale, stream);
    case 32:
      return launch_decode<T, 32>(q, k, v, table, pos, part, o, tp, batch,
                                  hq, hkv, ps, n, n_splits, pool_stride,
                                  scale, stream);
    case 64:
      return launch_decode<T, 64>(q, k, v, table, pos, part, o, tp, batch,
                                  hq, hkv, ps, n, n_splits, pool_stride,
                                  scale, stream);
    case 128:
      return launch_decode<T, 128>(q, k, v, table, pos, part, o, tp, batch,
                                   hq, hkv, ps, n, n_splits, pool_stride,
                                   scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Chunks (any C; the wrapper sends C > 1 here).  table (B, n) and pos (B,)
// int32 on the device; pool_stride is the element stride between shards of
// the pools; is_bf16: 1 for bfloat16 tensors, 0 for float32.  Returns the
// CUDA error of the launch (0 = launched).
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

// Decode (C = 1) through the split and combine kernels.  part is fp32
// scratch of (tp*B, Hkv, n_splits, g, D + 2) floats; n_splits must be
// ceil(n*ps / 64).  q and the pools (and the shard stride, in bytes) must
// be 16-byte aligned.  Returns the CUDA error of the launches.
int paged_decode_fwd(const void* q, const void* k, const void* v,
                     const void* table, const void* pos, void* part, void* o,
                     int tp, int batch, int hq, int hkv, int d, int ps, int n,
                     int n_splits, long long pool_stride, float scale,
                     int is_bf16, void* stream) {
  if (tp <= 0 || batch <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv || ps <= 0 || n <= 0 ||
      n_splits != (n * ps + KS - 1) / KS)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos);
  float* pt = static_cast<float*>(part);
  return is_bf16 ? dispatch_decode<__nv_bfloat16>(q, k, v, t, p, pt, o, tp,
                                                  batch, hq, hkv, d, ps, n,
                                                  n_splits, pool_stride,
                                                  scale, st)
                 : dispatch_decode<float>(q, k, v, t, p, pt, o, tp, batch, hq,
                                          hkv, d, ps, n, n_splits,
                                          pool_stride, scale, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
