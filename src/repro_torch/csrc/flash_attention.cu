// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_bhsd (body _flash_kernel).  On the TPU the grid walks the
// key blocks in order and carries the online-softmax state (m, l, acc) in
// VMEM scratch across grid steps.  Blocks on a GPU run in no order, so here
// ONE thread block owns one (q row, query tile) and loops over the key tiles
// itself, keeping m, l and acc in fp32 registers.
//
// Layout: q (BH, S, D), k/v (BHkv, S, D), heads-major; q row b reads kv row
// b / group (GQA by index, no head broadcast in memory).  Causal mask is
// top-left aligned (key index <= query index), as in the TPU kernel.  The
// ragged S edge is masked here, so the caller pads nothing.  A fully
// masked row divides by the 1e-20 clamp and comes out exactly 0.
//
// What bounds it: at the serving shapes (q (18, S <= 512, 64)) the whole
// call is at most 0.6 GFLOP and ~0.3 MB, under 1 us at the card's bf16
// tensor-core rate (989 TFLOP/s) and about as long at its memory rate.
// What sets the time is how fast the few products run and how long each
// block waits for its loads.  An fp32 kernel on CUDA cores (67 TFLOP/s,
// serial dot products from shared memory) ran at 0.6% of that bound.
//
// bf16 (the serving dtype), flash_fwd_tc_kernel, FlashAttention-2 style:
//   - 4 warps own a 64-query tile, 16 rows each; a warp's Q fragments stay
//     in registers for the whole key loop;
//   - K/V arrive in 64-key tiles straight from bf16 device memory into
//     bf16 shared memory by cp.async (16-byte copies, zero-filled past S),
//     through a ring of STAGES = 2 tiles (double buffering: tile t+1 loads
//     while tile t is computed); rows are padded by 16 bytes so that
//     ldmatrix has no bank conflicts;
//   - S = Q K^T and O += P V run on the tensor cores (mma.sync m16n8k16,
//     bf16 in, fp32 accumulate), fragments by ldmatrix (.trans for V);
//   - the online softmax stays in fp32 registers (quad shuffles for the
//     row max; the row sum is reduced once at the end), and P is rounded
//     to bf16 in registers as the A operand of P V;
//   - only the last key tile (the diagonal one, which also holds the
//     ragged edge) is masked; tiles above the diagonal are skipped, and
//     the longest query tiles are scheduled first.
// fp32 inputs keep the CUDA-core kernel (flash_fwd_kernel<float>): tensor
// cores in fp32 would mean TF32, which the fp32 tolerance (2e-5) forbids.
//
// Measured on an H100 SXM at 700 W (scripts/torch_flash_ablation.py):
// ~13 us at q (18, 512, 64) and ~11 us for one q row's 8 blocks alone, so
// the time is the serial chain of the longest block, ~1.0 (one row) to
// ~1.4 us (18 rows) per 64-key tile.  Doubling a tile's K/V copies adds ~24%, its P V products ~11%,
// its Q K^T products ~8%, its exponentials ~2%; a ring of 3 or 4 tiles
// adds nothing.  No one piece sets it: a tile's copy, two products and
// softmax follow one another in the one block that an SM runs.
//
// Left for later: more SMs on a long query tile (its key loop split over
// blocks, then combined), and wgmma with TMA and warp specialisation
// (ping-pong warpgroups overlap one tile's softmax with the next tile's
// products).  At these sizes (<= 144 blocks, under 1 us of work at the
// card's rates) mma.sync with cp.async was the simpler first match.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// fp32: CUDA cores, one thread block per (q row, 32-query tile)
// ---------------------------------------------------------------------------

constexpr int BQ = 32;                 // queries per block
constexpr int BK = 32;                 // keys per tile
constexpr int TPR = 4;                 // threads per query row
constexpr int THREADS = BQ * TPR;      // 128

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int group,
                 int s, float scale) {
  constexpr int LD = D + 1;            // +1 float: no bank conflicts
  constexpr int PJ = BK / TPR;         // score columns per thread
  constexpr int AJ = D / TPR;          // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // BQ x LD
  float* ks = qs + BQ * LD;            // BK x LD
  float* vs = ks + BK * LD;            // BK x LD
  float* ps = vs + BK * LD;            // BQ x (BK + 1)

  const int row = blockIdx.y;
  const int kv_row = row / group;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR;             // this thread's query in the tile
  const int tq = tid % TPR;            // its quarter of the columns
  const int qi = q0 + r;

  const T* qg = q + (size_t)row * s * D;
  const T* kg = k + (size_t)kv_row * s * D;
  const T* vg = v + (size_t)kv_row * s * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, cc = i % D;
    qs[rr * LD + cc] = (q0 + rr < s) ? to_f(qg[(size_t)(q0 + rr) * D + cc])
                                     : 0.f;
  }

  float acc[AJ];
#pragma unroll
  for (int j = 0; j < AJ; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;

  // key tiles past the tile's last query are fully masked: skip them
  const int n_tiles = (min(q0 + BQ, s) - 1) / BK + 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();                   // previous tile consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int rr = i / D, cc = i % D;
      const bool ok = k0 + rr < s;
      const size_t off = (size_t)(k0 + rr) * D + cc;
      ks[rr * LD + cc] = ok ? to_f(kg[off]) : 0.f;
      vs[rr * LD + cc] = ok ? to_f(vg[off]) : 0.f;
    }
    __syncthreads();

    float sc[PJ];
    bool ok[PJ];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int c = tq + TPR * j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qs[r * LD + d] * ks[c * LD + d];
      const int ki = k0 + c;
      ok[j] = ki <= qi && ki < s;
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
      ps[r * (BK + 1) + tq + TPR * j] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    const float corr = expf(m - m_new);
    l = l * corr + rs;
    m = m_new;
    __syncwarp();                      // the row's probabilities are in ps
#pragma unroll
    for (int j = 0; j < AJ; ++j) {
      const int d = tq + TPR * j;
      float a = acc[j] * corr;
#pragma unroll 8
      for (int c = 0; c < BK; ++c) a += ps[r * (BK + 1) + c] * vs[c * LD + d];
      acc[j] = a;
    }
  }

  if (qi < s) {
    const float denom = fmaxf(l, 1e-20f);
    T* og = o + ((size_t)row * s + qi) * D;
#pragma unroll
    for (int j = 0; j < AJ; ++j) store(&og[tq + TPR * j], acc[j] / denom);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int bh, int group, int s, float scale,
                       cudaStream_t stream) {
  using T = float;
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, s, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, one thread block per (q row, 64-query tile)
// ---------------------------------------------------------------------------

constexpr int TQ = 64;                 // queries per block: 4 warps x 16
constexpr int TK = 64;                 // keys per tile
constexpr int STAGES = 2;              // K/V tiles in the cp.async ring
constexpr int TC_THREADS = 128;
constexpr int PAD = 8;                 // bf16 per row: 16 bytes

template <int D>
constexpr int tc_smem_bytes() {
  return (TQ + 2 * STAGES * TK) * (D + PAD) * 2;  // Q, then the K/V ring
}

// rows [r0, r0 + 64) of a (rows, D) bf16 matrix into shared memory (row
// stride D + PAD), by cp.async; rows at or past s are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int s, int tid) {
  constexpr int CPR = D / 8;           // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < 64 * CPR; i += TC_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r0 + r < s;
    cp_async16(dst + r * (D + PAD) + c,
               ok ? src + (size_t)(r0 + r) * D + c : src, ok);
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * gid + tig.  An
// accumulator c[0..1] holds row gid, columns 2*tig, 2*tig+1 of its 8;
// c[2..3] the same columns of row gid + 8.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int group, int s,
                    float scale_log2) {
  constexpr int LD = D + PAD;
  constexpr int DK = D / 16;           // k-steps of Q K^T over D
  constexpr int NS = TK / 8;           // 8-key column blocks of S
  constexpr int NO = D / 8;            // 8-column blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + TQ * LD;    // STAGES x TK x LD
  __nv_bfloat16* vs = ks + STAGES * TK * LD;

  const int row = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int q0 = qt * TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* qg = q + (size_t)row * s * D;
  const __nv_bfloat16* kg = k + (size_t)(row / group) * s * D;
  const __nv_bfloat16* vg = v + (size_t)(row / group) * s * D;

  // TQ == TK, so the diagonal key tile is tile qt; it also holds the
  // ragged edge (q0 < s), and tiles past it are fully masked.  Copy group
  // i holds tile i (group 0 also Q); STAGES - 1 groups are in flight
  // before the loop and one more is committed (maybe empty) per tile.
  const int n_tiles = qt + 1;
  load_tile<D>(qs, qg, q0, s, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) {
      load_tile<D>(ks + t * TK * LD, kg, t * TK, s, tid);
      load_tile<D>(vs + t * TK * LD, vg, t * TK, s, tid);
    }
    cp_async_commit();
  }

  uint32_t qf[DK][4];
  float oacc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max (log2 units)
  float l[2] = {0.f, 0.f};               // this lane's part of the sum
  const int r_lo = q0 + warp * 16 + gid;   // this lane's two query rows

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();       // tile t has landed (this thread's
    __syncthreads();                   // part; the barrier: everyone's)
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qf[kk], qs + r * LD + kk * 16 + (lane >> 4) * 8);
      }
    }
    // refill the slot that tile t - 1 used: every thread is past it
    const int nxt = t + STAGES - 1;
    if (nxt < n_tiles) {
      load_tile<D>(ks + (nxt % STAGES) * TK * LD, kg, nxt * TK, s, tid);
      load_tile<D>(vs + (nxt % STAGES) * TK * LD, vg, nxt * TK, s, tid);
    }
    cp_async_commit();
    const __nv_bfloat16* kb = ks + (t % STAGES) * TK * LD;
    const __nv_bfloat16* vb = vs + (t % STAGES) * TK * LD;

    float sacc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; j += 2) {  // 16 keys per ldmatrix
        uint32_t b[4];
        const int key = j * 8 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(b, kb + key * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sacc[j], qf[kk], b[0], b[1]);
        mma_bf16(sacc[j + 1], qf[kk], b[2], b[3]);
      }
    }

    const int k0 = t * TK;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[j][e] * scale_log2;
        if (t == n_tiles - 1) {
          const int key = k0 + j * 8 + 2 * tig + (e & 1);
          const int qi = r_lo + (e >> 1) * 8;
          if (key > qi || key >= s) x = -INFINITY;
        }
        sacc[j][e] = x;
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {      // rows gid and gid + 8
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(sacc[j][2 * h], sacc[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      // a row with nothing visible yet keeps m = -inf: exp2(-inf) = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[h] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p0 = exp2f(sacc[j][2 * h] - m_use);
        const float p1 = exp2f(sacc[j][2 * h + 1] - m_use);
        sacc[j][2 * h] = p0;
        sacc[j][2 * h + 1] = p1;
        rs += p0 + p1;
      }
      l[h] = l[h] * corr + rs;
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        oacc[j][2 * h] *= corr;
        oacc[j][2 * h + 1] *= corr;
      }
    }

    // O += P V: the S accumulators of keys 16kk..16kk+15 are the A
    // fragment of k-step kk, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      pa[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      pa[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NO; j += 2) {  // 16 output columns per ldmatrix
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(b, vb + key * LD + j * 8 + (lane >> 4) * 8);
        mma_bf16(oacc[j], pa, b[0], b[1]);
        mma_bf16(oacc[j + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float denom = fmaxf(lt, 1e-20f);
    const int qi = r_lo + h * 8;
    if (qi < s) {
      __nv_bfloat16* og = o + ((size_t)row * s + qi) * D + 2 * tig;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(og + j * 8) =
            __floats2bfloat162_rn(oacc[j][2 * h] / denom,
                                  oacc[j][2 * h + 1] / denom);
      }
    }
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int bh, int group, int s, float scale,
                      cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + TQ - 1) / TQ, bh);
  flash_fwd_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      group, s, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int group, int s, float scale, int is_bf16,
                   cudaStream_t stream) {
  return is_bf16 ? launch_tc<D>(q, k, v, o, bh, group, s, scale, stream)
                 : launch_f32<D>(q, k, v, o, bh, group, s, scale, stream);
}

}  // namespace

extern "C" {

// is_bf16: 1 for bfloat16 tensors (tensor-core kernel; q, k, v and o
// 16-byte aligned), 0 for float32 (CUDA-core kernel).  Returns the CUDA
// error of the launch (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int bh, int group, int s, int d, float scale,
                        int is_bf16, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, o, bh, group, s, scale, is_bf16, st);
    case 32: return launch<32>(q, k, v, o, bh, group, s, scale, is_bf16, st);
    case 64: return launch<64>(q, k, v, o, bh, group, s, scale, is_bf16, st);
    case 128:
      return launch<128>(q, k, v, o, bh, group, s, scale, is_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
