// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _kernel).  On the TPU one grid row is one (batch*head) stream, the chunk
// axis is the minor grid axis, and the (P, N) state lives in VMEM scratch
// from one grid step to the next.  Blocks on a GPU run in no order and
// carry nothing to each other, so here the scan is cut where Mamba2's own
// GPU kernels cut it.  Per chunk (csum = cumsum(dt * a) over its rows):
//   y_i   = sum_{j<=i} (C_i . B_j) exp(csum_i - csum_j) dt_j x_j
//         + exp(csum_i) C_i . state_in + D x_i
//   state = exp(csum_last) state_in
//         + sum_j exp(csum_last - csum_j) dt_j x_j B_j^T.
// Decays are always formed as exp of a DIFFERENCE of cumulative sums
// (every exponent is <= 0), never as a ratio of exps.
//
// Layout: x, y (Bt, S, H, P); dt (Bt, S, H) fp32; a, D (Bt, H) fp32; B and C
// (Bt, S, G, N) read at group h / (H / G) through their (batch, token)
// strides, so neither the G -> H broadcast nor a B/C split of the fused
// projection is materialised.  The final state is written as (Bt, H, P, N)
// fp32.  The ragged S edge is masked here (rows past S act as dt = 0 and
// x = 0, which leaves the outputs and the state exact), so the caller pads
// nothing.
//
// bf16 (the serving dtype): three kernels on one stream, launched by one
// call, every product on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate; fragments by ldmatrix; 64-row tiles copied by
// cp.async, zero-filled past the chunk's rows, in rows padded by 16 bytes):
//   1. ssd_scores_kernel: CB = C . B^T for each 64x64 tile pair on or
//      below the diagonal of each (row, group, chunk), into an fp32 scratch
//      (Bt, chunks, G, Qp, Qp), Qp = chunk rounded up to 64.  The scores
//      depend on the group only, so they are formed ONCE per (row, group,
//      chunk) and read by every head of the group (at G = 1, 16 heads).
//      Other blocks of the same launch write each (stream, chunk)'s cumsum
//      and dt to a scan scratch, so (2) and (3) copy them in one piece and
//      see the same csum.
//   2. ssd_states_kernel, one block per (stream, chunk, 64 state columns):
//      the chunk's own state sum_j w_j x_j B_j^T, w_j = exp(csum_last -
//      csum_j) dt_j, into an fp32 scratch (Bt, H, chunks, P, N).  The final
//      state is held to 2e-5 of its largest entry, and one bf16 rounding of
//      w_j x_j costs 2^-9 a term, so w_j x_j is split into a bf16 hi part
//      and a bf16 rest, two products (2^-17 a term); B and x are bf16
//      already and exact.
//   3. ssd_output_kernel, one block per (stream, chunk, 64-row query tile),
//      the longest tiles first, 8 warps (two halves of each key tile): the
//      state entering the chunk, passed over the chunk states before it in
//      fp32 and rounded to bf16, for exp(csum_i) C_i . state_in; then over
//      the key tiles at or below the diagonal the scores of (1), weighted
//      by exp(csum_i - csum_j) dt_j and the causal mask in registers and
//      rounded to bf16 there (as the flash kernel rounds P) as the A operand
//      of the product with x; plus D x_i.  y is held to one bf16 step of
//      its largest value, which these roundings keep to.  One more block
//      per stream passes the states to the end and writes the final state.
// Scratch comes from the caller (no allocation here).
// fp32 inputs keep the CUDA-core kernel (ssd_scan_kernel<float>, below):
// tensor cores in fp32 would mean TF32, which the 2e-5 tolerance forbids.
//
// What bounds it: at the serving shape (x (2, 300, 16, 64), B/C (2, 300,
// 1, 128), chunk 256) the call must move ~3.9 MB (1.15 us at 3.35 TB/s)
// and do ~0.47 GFLOP (0.5 us at 989 TFLOP/s bf16): bytes bound it.  The
// scratch (~1-2 MB) stays in the 50 MB L2.  Measured on an H100 SXM at
// 700 W: ~23 us for the three launches at that shape (~4 scores, ~8
// states, ~11 output).  Per-block timestamps show what sets it: the copies
// into each SM (B is read by every head's blocks, the scores by every
// head's query tiles; an SM's share of L2 bandwidth is ~40 GB/s), a
// ~1.3 us chain per key tile in the longest query tiles, and each
// launch's fixed cost, not either roofline.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores.  ONE thread block owns one stream (batch row, head)
// and a tile of TP = 16 of its P columns, and loops over the chunks itself
// with its (TP, N) state tile in shared memory (exact: state row p and
// output column p depend only on x column p).  64-row query tiles walk the
// 64-row key tiles at or below them, forming C_i . B_j on the fly from
// shared memory (each column block recomputes the scores).
// ---------------------------------------------------------------------------

constexpr int TP = 16;                 // P columns per block
constexpr int BT = 64;                 // rows per query / key tile
constexpr int THREADS = 256;
constexpr int MAX_CHUNK = THREADS;     // the cumsum gives one row per thread
constexpr int MAX_N = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int YR = THREADS / TP;       // 16: row stride of a thread's y rows
constexpr int SU = TP * MAX_N / THREADS;  // state entries per thread (max)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

int smem_floats(int n) {
  const int ldn = n + 1;               // +1: no bank conflicts across rows
  return 2 * MAX_CHUNK + MAX_CHUNK * TP + TP * ldn + 2 * BT * ldn +
         BT * (BT + 1) + NWARPS;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dd,
                T* __restrict__ y, float* __restrict__ state_out, int s,
                int h, int p, int g, int n, int chunk, long long bc_sb,
                long long bc_st) {
  extern __shared__ float smem[];
  const int ldn = n + 1;
  float* csum = smem;                  // MAX_CHUNK
  float* dts = csum + MAX_CHUNK;       // MAX_CHUNK: dt, then the state weights
  float* xs = dts + MAX_CHUNK;         // MAX_CHUNK x TP
  float* st = xs + MAX_CHUNK * TP;     // TP x ldn: the state tile
  float* cs = st + TP * ldn;           // BT x ldn: C of the query tile
  float* bs = cs + BT * ldn;           // BT x ldn: B of the key tile
  float* sc = bs + BT * ldn;           // BT x (BT + 1): scores
  float* wtot = sc + BT * (BT + 1);    // NWARPS: scan carries

  const int p0 = blockIdx.x * TP;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = hh / (h / g);
  const float av = a[(size_t)b * h + hh];
  const float dv = dd[(size_t)b * h + hh];
  const size_t xrow = (size_t)h * p;   // elements between tokens of x / y
  const T* xg = x + (size_t)b * s * xrow + (size_t)hh * p + p0;
  T* yg = y + (size_t)b * s * xrow + (size_t)hh * p + p0;
  const float* dtg = dt + (size_t)b * s * h + hh;
  const T* bg = bm + b * bc_sb + (long long)grp * n;
  const T* cg = cm + b * bc_sb + (long long)grp * n;

  const int cp = tid % TP;             // y: this thread's column ...
  const int cr = tid / TP;             // ... and rows cr + YR * r
  const int ty = tid / 16, tx = tid % 16;  // scores: rows ty + 16 r, cols tx + 16 c

  for (int e = tid; e < TP * ldn; e += THREADS) st[e] = 0.f;

  for (int c0 = 0; c0 < s; c0 += chunk) {
    const int nr = min(chunk, s - c0);
    const int nt = (nr + BT - 1) / BT;
    __syncthreads();                   // the previous chunk is consumed

    // dt, and the inclusive cumsum of dt * a over the chunk (flat past nr)
    float v = 0.f;
    if (tid < nr) {
      const float d = dtg[(size_t)(c0 + tid) * h];
      dts[tid] = d;
      v = d * av;
    } else {
      dts[tid] = 0.f;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) wtot[warp] = v;
    for (int e = tid; e < nt * BT * TP; e += THREADS) {
      const int j = e / TP, q = e % TP;
      xs[e] = j < nr ? to_f(xg[(size_t)(c0 + j) * xrow + q]) : 0.f;
    }
    __syncthreads();
    if (warp == 0) {
      float t = lane < NWARPS ? wtot[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < NWARPS; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += u;
      }
      if (lane < NWARPS) wtot[lane] = t;
    }
    __syncthreads();
    if (warp > 0) v += wtot[warp - 1];
    csum[tid] = v;
    __syncthreads();

    for (int qt = 0; qt < nt; ++qt) {
      const int i0 = qt * BT;
      for (int e = tid; e < BT * n; e += THREADS) {
        const int r = e / n, k = e % n;
        cs[r * ldn + k] =
            i0 + r < nr ? to_f(cg[(long long)(c0 + i0 + r) * bc_st + k]) : 0.f;
      }
      __syncthreads();
      // the carried state's contribution: exp(csum_i) C_i . state[p]
      float acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = cr + YR * r;
        float dot = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) dot += cs[i * ldn + k] * st[cp * ldn + k];
        acc[r] = expf(csum[i0 + i]) * dot;
      }
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * BT;
        for (int e = tid; e < BT * n; e += THREADS) {
          const int r = e / n, k = e % n;
          bs[r * ldn + k] = j0 + r < nr
              ? to_f(bg[(long long)(c0 + j0 + r) * bc_st + k]) : 0.f;
        }
        __syncthreads();
        float d4[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) d4[r][c] = 0.f;
#pragma unroll 2
        for (int k = 0; k < n; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * ldn + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = bs[(tx + 16 * c) * ldn + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) d4[r][c] += cv[r] * bv[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = ty + 16 * r, j = tx + 16 * c;
            const int gi = i0 + i, gj = j0 + j;
            sc[i * (BT + 1) + j] = gj <= gi
                ? d4[r][c] * expf(csum[gi] - csum[gj]) * dts[gj] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < BT; ++j) {
          const float xv = xs[(j0 + j) * TP + cp];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[r] += sc[(cr + YR * r) * (BT + 1) + j] * xv;
        }
        __syncthreads();               // bs, sc and cs are rewritten next
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + cr + YR * r;
        if (i < nr)
          store(&yg[(size_t)(c0 + i) * xrow + cp],
                acc[r] + dv * xs[i * TP + cp]);
      }
    }

    // state <- exp(total) state + sum_j exp(total - csum_j) dt_j x_j B_j^T
    const float total = csum[nr - 1];
    dts[tid] = tid < nr ? expf(total - csum[tid]) * dts[tid] : 0.f;
    float su[SU];
#pragma unroll
    for (int m = 0; m < SU; ++m) su[m] = 0.f;
    for (int kt = 0; kt < nt; ++kt) {
      const int j0 = kt * BT;
      __syncthreads();                 // dts written; bs free
      for (int e = tid; e < BT * n; e += THREADS) {
        const int r = e / n, k = e % n;
        bs[r * ldn + k] = j0 + r < nr
            ? to_f(bg[(long long)(c0 + j0 + r) * bc_st + k]) * dts[j0 + r]
            : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < SU; ++m) {
        const int e = tid + THREADS * m;
        if (e < TP * n) {
          const int q = e / n, k = e % n;
          float u = 0.f;
#pragma unroll 4
          for (int j = 0; j < BT; ++j)
            u += xs[(j0 + j) * TP + q] * bs[j * ldn + k];
          su[m] += u;
        }
      }
    }
    const float decay = expf(total);
#pragma unroll
    for (int m = 0; m < SU; ++m) {
      const int e = tid + THREADS * m;
      if (e < TP * n) {
        const int q = e / n, k = e % n;
        st[q * ldn + k] = decay * st[q * ldn + k] + su[m];
      }
    }
  }
  __syncthreads();
  float* sg = state_out + ((size_t)b * h + hh) * p * n + (size_t)p0 * n;
  for (int e = tid; e < TP * n; e += THREADS)
    sg[e] = st[(e / n) * ldn + e % n];
}

cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* bm, const void* cm, const float* dd, void* y,
                   float* state, int bt, int s, int h, int p, int g, int n,
                   int chunk, long long bc_sb, long long bc_st,
                   cudaStream_t stream) {
  using T = float;
  const int smem = smem_floats(n) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p / TP, h, bt);
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), dd, static_cast<T*>(y), state, s, h, p, g,
      n, chunk, bc_sb, bc_st);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, three kernels (see the top of the file)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_THREADS = 128;        // 4 warps x 16 rows of a 64-row tile
constexpr int OUT_THREADS = 256;       // the output kernel: 2 x 4 warps
constexpr int TILE = 64;
constexpr int PAD = 8;                 // bf16 per row: 16 bytes
constexpr int TC_MAX_N = 128;
constexpr float LOG2E = 1.4426950408889634f;
// the scan scratch holds, per (stream, chunk), csum then dt (0 past the
// chunk's rows), MAX_CHUNK floats each
constexpr int SCAN_ROW = 2 * MAX_CHUNK;

// wait until at most `pending` (0..3) of this thread's newest cp.async
// groups are still in flight
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// rows [r0, r0 + 64) of a bf16 matrix of width w (rows ld elements apart)
// into shared memory (row stride w + PAD), by cp.async; rows at or past nr
// are zero-filled (and not read)
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, int r0, int nr,
                                          int w) {
  const int cpr = w / 8;               // 16-byte pieces per row
  for (int i = threadIdx.x; i < TILE * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i % cpr) * 8;
    const bool ok = r0 + r < nr;
    cp_async16(dst + r * (w + PAD) + c,
               ok ? src + (long long)(r0 + r) * ld + c : src, ok);
  }
}

// nf floats (a multiple of 4, 16-byte aligned) into shared memory
__device__ __forceinline__ void load_floats(float* dst, const float* src,
                                            int nf) {
  for (int i = 4 * threadIdx.x; i < nf; i += 4 * blockDim.x)
    cp_async16(dst + i, src + i, true);
}

// A fragment of rows [16 * rt, 16 * rt + 16) of a row-major tile (row
// stride ld), columns [k0, k0 + 16)
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const bf16* base,
                                       int ld, int rt, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(f, base + (rt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                     k0 + (lane >> 4) * 8);
}

// B fragments of output columns [n0, n0 + 16) (two 8-column blocks: f[0..1]
// and f[2..3]), k = [k0, k0 + 16), from a tile stored [column][k]
__device__ __forceinline__ void load_b_nk(uint32_t (&f)[4], const bf16* base,
                                          int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(f, base + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
}

// the same from a tile stored [k][column]
__device__ __forceinline__ void load_b_kn(uint32_t (&f)[4], const bf16* base,
                                          int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(f, base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           n0 + (lane >> 4) * 8);
}

// 1. a 1-D grid of two kinds of block.  The first Bt * G * chunks * pairs
// form CB = C . B^T for one 64x64 tile pair (qt, kt <= qt) of one (row,
// group, chunk) into cb.  The next Bt * H * chunks form the inclusive
// cumsum of dt * a over one (stream, chunk), two rows a thread, into the
// scan scratch with dt, so that (2) and (3) copy it in one piece.
__global__ void __launch_bounds__(TC_THREADS)
ssd_scores_kernel(const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                  const float* __restrict__ dt, const float* __restrict__ a,
                  float* __restrict__ cb, float* __restrict__ scan, int bt,
                  int s, int h, int g, int n, int chunk, int qp,
                  long long bc_sb, long long bc_st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (s + chunk - 1) / chunk;
  const int tmax = qp / TILE, pairs = tmax * (tmax + 1) / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int id = blockIdx.x;
  if (id >= bt * g * nc * pairs) {     // a scan block
    id -= bt * g * nc * pairs;
    const int c = id % nc, sid = id / nc;   // sid = b * h + head
    const int b = sid / h, hh = sid % h;
    const int c0 = c * chunk, nr = min(chunk, s - c0);
    const float* dtg = dt + ((size_t)b * s + c0) * h + hh;
    const float av = a[sid];
    const int r = 2 * tid;
    const float d0 = r < nr ? dtg[(size_t)r * h] : 0.f;
    const float d1 = r + 1 < nr ? dtg[(size_t)(r + 1) * h] : 0.f;
    const float v0 = d0 * av, v1 = v0 + d1 * av;
    float inc = v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    float ex = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) ex = 0.f;
    float* carry = reinterpret_cast<float*>(smem_raw);
    if (lane == 31) carry[warp] = inc;
    __syncthreads();
    float base = ex;
    for (int w = warp - 1; w >= 0; --w) base = carry[w] + base;
    float* out = scan + ((size_t)sid * nc + c) * SCAN_ROW;
    *reinterpret_cast<float2*>(out + r) = make_float2(base + v0, base + v1);
    *reinterpret_cast<float2*>(out + MAX_CHUNK + r) = make_float2(d0, d1);
    return;
  }
  const int pr = id % pairs, c = (id / pairs) % nc;
  const int bg = id / (pairs * nc), b = bg / g, grp = bg % g;
  const int ldn = n + PAD;
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // TILE x ldn
  bf16* bs = cs + TILE * ldn;                    // TILE x ldn
  const int c0 = c * chunk, nr = min(chunk, s - c0);
  const int nt = (nr + TILE - 1) / TILE;
  int qt = 0, kt = pr;                 // pair index -> (qt, kt), row-major
  while (kt > qt) {
    kt -= qt + 1;
    ++qt;
  }
  if (qt >= nt) return;
  const long long off =
      b * bc_sb + (long long)c0 * bc_st + (long long)grp * n;
  load_rows(cs, cm + off, bc_st, qt * TILE, nr, n);
  load_rows(bs, bm + off, bc_st, kt * TILE, nr, n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[8][4] = {};
  for (int k0 = 0; k0 < n; k0 += 16) {
    uint32_t fa[4];
    load_a(fa, cs, ldn, warp, k0);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t fb[4];
      load_b_nk(fb, bs, ldn, j * 8, k0);
      mma_bf16(acc[j], fa, fb[0], fb[1]);
      mma_bf16(acc[j + 1], fa, fb[2], fb[3]);
    }
  }
  float* out = cb + (((size_t)b * nc + c) * g + grp) * qp * qp +
               (size_t)(qt * TILE + warp * 16 + (lane >> 2)) * qp +
               kt * TILE + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(out + j * 8) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + 8 * (size_t)qp + j * 8) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// 2. columns [n0, n0 + 64) of the chunk's own state sum_j w_j x_j B_j^T
// of one (stream, chunk); grid (chunks * ceil(N / 64), H, Bt), 8 warps.
// The chunk's x and B are copied in one round.  The state is cut into
// 16 x 16 items (row tile, column pair); warp w takes row tile w % (P / 16)
// and the pairs (w + 8 m) / (P / 16); w_j x_j = hi + rest, both bf16, one
// product each.
constexpr int ST_THREADS = 256;
constexpr int NCOL = 64;               // state columns a block

template <int P>
__global__ void __launch_bounds__(ST_THREADS)
ssd_states_kernel(const bf16* __restrict__ x, const bf16* __restrict__ bm,
                  const float* __restrict__ scan, float* __restrict__ cstate,
                  int s, int h, int g, int n, int chunk, long long bc_sb,
                  long long bc_st) {
  constexpr int LDX = P + PAD;
  constexpr int PT = P / 16;
  constexpr int IPW = (PT * (NCOL / 16) + 7) / 8;  // items a warp, at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* csum = reinterpret_cast<float*>(smem_raw);
  float* ws = csum + MAX_CHUNK;        // dt, then the weights w
  // the chunk's rows: x, then bf16(w x), in xr; bf16(w x - hi) in xl; this
  // block's columns of B in br
  bf16* xr = reinterpret_cast<bf16*>(csum + SCAN_ROW);
  bf16* xl = xr + MAX_CHUNK * LDX;
  bf16* br = xl + MAX_CHUNK * LDX;

  const int nparts = (n + NCOL - 1) / NCOL;
  const int part = blockIdx.x % nparts, c = blockIdx.x / nparts;
  const int n0 = part * NCOL, nw = min(NCOL, n - n0), ldb = nw + PAD;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / nparts;
  const int c0 = c * chunk, nr = min(chunk, s - c0);
  const int nt = (nr + TILE - 1) / TILE;
  const int grp = hh / (h / g);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t sid = (size_t)b * h + hh;
  const long long xrow = (long long)h * P;
  const bf16* xg = x + ((size_t)b * s + c0) * xrow + (size_t)hh * P;
  const bf16* bg =
      bm + b * bc_sb + (long long)c0 * bc_st + (long long)grp * n + n0;

  load_floats(csum, scan + (sid * nc + c) * SCAN_ROW, SCAN_ROW);
  for (int t = 0; t < nt; ++t) {
    load_rows(xr + t * TILE * LDX, xg, xrow, t * TILE, nr, P);
    load_rows(br + t * TILE * ldb, bg, bc_st, t * TILE, nr, nw);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float total = csum[nr - 1];
  for (int j = tid; j < MAX_CHUNK; j += ST_THREADS)
    ws[j] = j < nr ? expf(total - csum[j]) * ws[j] : 0.f;
  __syncthreads();
  // w x -> bf16 hi (in place of x) + bf16 rest, 8 columns at a time
  for (int e = tid; e < nt * TILE * P / 8; e += ST_THREADS) {
    const int r = e / (P / 8), q = (e % (P / 8)) * 8;
    uint4* px = reinterpret_cast<uint4*>(xr + r * LDX + q);
    uint4 raw = *px, rest;
    const float w = ws[r];
    uint32_t* hw = reinterpret_cast<uint32_t*>(&raw);
    uint32_t* lw = reinterpret_cast<uint32_t*>(&rest);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&hw[k]));
      const float v0 = w * v.x, v1 = w * v.y;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
      const float2 hf = __bfloat1622float2(hi);
      hw[k] = *reinterpret_cast<const uint32_t*>(&hi);
      lw[k] = pack_bf16(v0 - hf.x, v1 - hf.y);
    }
    *px = raw;
    *reinterpret_cast<uint4*>(xl + r * LDX + q) = rest;
  }
  __syncthreads();

  const int pt = warp % PT;            // 8 % PT == 0: the same for every m
  float acc[IPW][2][4] = {}, acl[IPW][2][4] = {};  // the hi and rest sums
#pragma unroll 2
  for (int k0 = 0; k0 < nt * TILE; k0 += 16) {
    // A = (w x)^T: rows p, k = j, from the [j][p] tiles (ldmatrix.trans)
    uint32_t ah[4], al[4];
    const int off = (k0 + (lane & 7) + (lane >> 4) * 8) * LDX + pt * 16 +
                    ((lane >> 3) & 1) * 8;
    ldmatrix_x4_trans(ah, xr + off);
    ldmatrix_x4_trans(al, xl + off);
#pragma unroll
    for (int m = 0; m < IPW; ++m) {
      const int jp = (warp + 8 * m) / PT;
      if (16 * jp < nw) {
        uint32_t fb[4];
        load_b_kn(fb, br, ldb, jp * 16, k0);
        mma_bf16(acc[m][0], ah, fb[0], fb[1]);
        mma_bf16(acl[m][0], al, fb[0], fb[1]);
        mma_bf16(acc[m][1], ah, fb[2], fb[3]);
        mma_bf16(acl[m][1], al, fb[2], fb[3]);
      }
    }
  }
  float* out = cstate + (sid * nc + c) * P * n +
               (size_t)(pt * 16 + (lane >> 2)) * n + n0;
#pragma unroll
  for (int m = 0; m < IPW; ++m) {
    const int jp = (warp + 8 * m) / PT;
    if (16 * jp >= nw) continue;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = jp * 16 + u * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + col) =
          make_float2(acc[m][u][0] + acl[m][u][0],
                      acc[m][u][1] + acl[m][u][1]);
      *reinterpret_cast<float2*>(out + 8 * (size_t)n + col) =
          make_float2(acc[m][u][2] + acl[m][u][2],
                      acc[m][u][3] + acl[m][u][3]);
    }
  }
}

// state <- exp(total_k) state + own_k over chunks [0, kend) of one stream,
// VB float4s a thread at a time; `put(e, v)` takes float4 e of the result
template <int VB, typename Put>
__device__ __forceinline__ void pass_states(const float* scan,
                                            const float* cstate, int s,
                                            int chunk, int q4, int kend,
                                            Put put) {
  const float4* cst = reinterpret_cast<const float4*>(cstate);
  for (int e0 = threadIdx.x; e0 < q4; e0 += VB * blockDim.x) {
    float4 run[VB], v[VB];
#pragma unroll
    for (int u = 0; u < VB; ++u) run[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < kend; ++k) {
#pragma unroll
      for (int u = 0; u < VB; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < q4) v[u] = cst[(size_t)k * q4 + e];
      }
      const float d = expf(scan[(size_t)k * SCAN_ROW +
                                min(chunk, s - k * chunk) - 1]);
#pragma unroll
      for (int u = 0; u < VB; ++u)
        run[u] = make_float4(d * run[u].x + v[u].x, d * run[u].y + v[u].y,
                             d * run[u].z + v[u].z, d * run[u].w + v[u].w);
    }
#pragma unroll
    for (int u = 0; u < VB; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < q4) put(e, run[u]);
    }
  }
}

// 3. y of one 64-row query tile of one (stream, chunk); grid (Bt * H,
// chunks, tiles + 1): z = 0 passes the states and writes the final state
// (the last chunk's; the others exit), z >= 1 takes query tile tiles - z,
// so that the longest tiles of every chunk go first.  Copy group t holds x
// tile t and this tile's scores against key tile t (group 0 also csum, dt
// and C); the x tiles are all copied at the start, the scores through a
// ring of two.  Warps 0-3 take rows 16 w and keys [0, 32) of each key
// tile, warps 4-7 the same rows and keys [32, 64) (and half the k-steps of
// C . state); the halves are summed at the end.
template <int P>
__global__ void __launch_bounds__(OUT_THREADS)
ssd_output_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cm,
                  const float* __restrict__ dd, const float* __restrict__ cb,
                  const float* __restrict__ scan,
                  const float* __restrict__ cstate, bf16* __restrict__ y,
                  float* __restrict__ state_out, int s, int h, int g, int n,
                  int chunk, int qp, long long bc_sb, long long bc_st) {
  constexpr int LDX = P + PAD;
  constexpr int LDC = TILE + 8;        // floats: float2 reads conflict-free
  constexpr int NP = P / 8;            // 8-column blocks of y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldn = n + PAD, tmax = qp / TILE;
  float* csum = reinterpret_cast<float*>(smem_raw);
  float* dts = csum + MAX_CHUNK;
  // the scores, 2 x TILE x LDC (then the second half's 4 x 16 x P)
  float* cbs = csum + SCAN_ROW;
  bf16* xs = reinterpret_cast<bf16*>(  // x tiles
      cbs + (2 * TILE * LDC > 64 * P ? 2 * TILE * LDC : 64 * P));
  bf16* cs = xs + tmax * TILE * LDX;   // TILE x ldn: C of the query tile
  bf16* sts = cs + TILE * ldn;         // P x ldn: the state coming in

  const int c = blockIdx.y, nc = gridDim.y;
  const int b = blockIdx.x / h, hh = blockIdx.x % h;
  const size_t sid = (size_t)b * h + hh;
  const float* scan_s = scan + sid * nc * SCAN_ROW;
  const float* cst_s = cstate + sid * nc * P * n;
  if (blockIdx.z == 0) {               // the final state
    if (c == nc - 1)
      pass_states<4>(scan_s, cst_s, s, chunk, P * n / 4, nc,
                     [&](int e, float4 v) {
                       reinterpret_cast<float4*>(state_out + sid * P * n)[e] =
                           v;
                     });
    return;
  }
  const int c0 = c * chunk, nr = min(chunk, s - c0);
  const int nt = (nr + TILE - 1) / TILE;
  const int qt = nt - (int)blockIdx.z;
  if (qt < 0) return;
  const int i0 = qt * TILE;
  const int grp = hh / (h / g);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rt = warp & 3, kh = warp >> 2;   // row tile, half of the keys
  const int gid = lane >> 2, tig = lane & 3;
  const long long xrow = (long long)h * P;
  const bf16* xg = x + ((size_t)b * s + c0) * xrow + (size_t)hh * P;
  const float* cbg = cb + (((size_t)b * nc + c) * g + grp) * qp * qp +
                     (size_t)i0 * qp;

  load_floats(csum, scan_s + (size_t)c * SCAN_ROW, SCAN_ROW);
  if (c > 0)
    load_rows(cs, cm + b * bc_sb + (long long)c0 * bc_st + (long long)grp * n,
              bc_st, i0, nr, n);
  auto load_scores = [&](int t) {      // into slot t % 2
    for (int i = tid; i < TILE * TILE / 4; i += OUT_THREADS) {
      const int r = i / (TILE / 4), q = (i % (TILE / 4)) * 4;
      cp_async16(cbs + ((t & 1) * TILE + r) * LDC + q,
                 cbg + (size_t)r * qp + t * TILE + q, true);
    }
  };
  for (int t = 0; t <= qt; ++t) {
    load_rows(xs + t * TILE * LDX, xg, xrow, t * TILE, nr, P);
    if (t < 2) load_scores(t);
    cp_async_commit();
  }
  // the state entering the chunk (fp32 sums), rounded to bf16 [p][n]
  if (c > 0)
    pass_states<4>(scan_s, cst_s, s, chunk, P * n / 4, c,
                   [&](int e, float4 v) {
                     bf16* d4 = sts + (4 * e / n) * ldn + 4 * e % n;
                     *reinterpret_cast<__nv_bfloat162*>(d4) =
                         __floats2bfloat162_rn(v.x, v.y);
                     *reinterpret_cast<__nv_bfloat162*>(d4 + 2) =
                         __floats2bfloat162_rn(v.z, v.w);
                   });

  float acc[NP][4] = {};
  const int r_lo = i0 + rt * 16 + gid;  // this lane's rows in the chunk
  for (int t = 0; t <= qt; ++t) {
    // group t landed (x tile t, scores t); the state is in shared memory;
    // the scores of tile t - 1 are consumed, so slot (t + 1) % 2 takes
    // tile t + 1 (groups 0 and 1 brought tiles 0 and 1)
    cp_async_wait_upto(t == 0 ? qt : 0);
    __syncthreads();
    if (t >= 1 && t < qt) {
      load_scores(t + 1);
      cp_async_commit();
    }
    if (t == 0 && c > 0) {
      // exp(csum_i) C_i . state_in over this half's k-steps (B [p][n])
      for (int k0 = 16 * kh; k0 < n; k0 += 32) {
        uint32_t fa[4];
        load_a(fa, cs, ldn, rt, k0);
#pragma unroll
        for (int j = 0; j < NP; j += 2) {
          uint32_t fb[4];
          load_b_nk(fb, sts, ldn, j * 8, k0);
          mma_bf16(acc[j], fa, fb[0], fb[1]);
          mma_bf16(acc[j + 1], fa, fb[2], fb[3]);
        }
      }
      const float e0 = expf(csum[r_lo]), e1 = expf(csum[r_lo + 8]);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
    }
    // this half's keys: CB_ij exp(csum_i - csum_j) dt_j for j <= i, else
    // 0, rounded to bf16 as the A operand of the product with x
    const int k0 = t * TILE + 32 * kh;
    const float* cbr = cbs + ((t & 1) * TILE + rt * 16 + gid) * LDC +
                       32 * kh + 2 * tig;
    float sc[4][4];
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float2 v =
            *reinterpret_cast<const float2*>(cbr + u * 8 * LDC + jb * 8);
        const int i = r_lo + 8 * u;
        const int j = k0 + jb * 8 + 2 * tig;
        sc[jb][2 * u] =
            j <= i ? v.x * exp2f((csum[i] - csum[j]) * LOG2E) * dts[j] : 0.f;
        sc[jb][2 * u + 1] =
            j + 1 <= i
                ? v.y * exp2f((csum[i] - csum[j + 1]) * LOG2E) * dts[j + 1]
                : 0.f;
      }
    }
    const bf16* xb = xs + (t * TILE + 32 * kh) * LDX;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NP; j += 2) {
        uint32_t fb[4];
        load_b_kn(fb, xb, LDX, j * 8, kk * 16);
        mma_bf16(acc[j], pa, fb[0], fb[1]);
        mma_bf16(acc[j + 1], pa, fb[2], fb[3]);
      }
    }
  }

  // the second half hands its sums to the first (through the scores'
  // space), which adds D x_i (from the diagonal tile, qt) and stores y
  __syncthreads();
  float* rw = cbs + (rt * 16 + gid) * P + 2 * tig;
  if (kh) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      *reinterpret_cast<float2*>(rw + j * 8) = make_float2(acc[j][0],
                                                           acc[j][1]);
      *reinterpret_cast<float2*>(rw + 8 * P + j * 8) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
  if (kh) return;
  const float dv = dd[sid];
  const bf16* xb = xs + qt * TILE * LDX;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = rt * 16 + gid + 8 * u;
    if (i0 + i >= nr) continue;
    bf16* yr = y + ((size_t)b * s + c0 + i0 + i) * xrow + (size_t)hh * P +
               2 * tig;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xb + i * LDX + j * 8 +
                                                    2 * tig));
      const float2 o = *reinterpret_cast<const float2*>(rw + 8 * u * P +
                                                        j * 8);
      *reinterpret_cast<__nv_bfloat162*>(yr + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * u] + o.x + dv * xv.x, acc[j][2 * u + 1] + o.y + dv * xv.y);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int P>
cudaError_t launch_tc(const void* x, const float* dt, const float* a,
                      const void* bm, const void* cm, const float* dd,
                      void* y, float* state, float* cb, float* cstate,
                      float* scan, int bt, int s, int h, int g, int n,
                      int chunk, long long bc_sb, long long bc_st,
                      cudaStream_t stream) {
  const int nc = (s + chunk - 1) / chunk;
  const int tmax = (chunk + TILE - 1) / TILE, qp = tmax * TILE;
  const int ldn = n + PAD;
  const int smem1 = 2 * TILE * ldn * 2;
  const int nparts = (n + NCOL - 1) / NCOL;
  const int smem2 =
      SCAN_ROW * 4 + MAX_CHUNK * (2 * (P + PAD) + min(n, NCOL) + PAD) * 2;
  const int cbf = 2 * TILE * (TILE + 8);  // as the kernel lays it out
  const int smem3 = (SCAN_ROW + (cbf > 64 * P ? cbf : 64 * P)) * 4 +
                    (tmax * TILE * (P + PAD) + TILE * ldn + P * ldn) * 2;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* bb = static_cast<const bf16*>(bm);
  const auto* cc = static_cast<const bf16*>(cm);
  cudaError_t err = allow_smem(ssd_scores_kernel, smem1);
  if (err == cudaSuccess) err = allow_smem(ssd_states_kernel<P>, smem2);
  if (err == cudaSuccess) err = allow_smem(ssd_output_kernel<P>, smem3);
  if (err != cudaSuccess) return err;
  const long long blocks1 =
      (long long)nc * (bt * g * tmax * (tmax + 1) / 2 + bt * h);
  ssd_scores_kernel<<<(unsigned)blocks1, TC_THREADS, smem1, stream>>>(
      bb, cc, dt, a, cb, scan, bt, s, h, g, n, chunk, qp, bc_sb, bc_st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_states_kernel<P><<<dim3(nc * nparts, h, bt), ST_THREADS, smem2,
                         stream>>>(xb, bb, scan, cstate, s, h, g, n, chunk,
                                   bc_sb, bc_st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_output_kernel<P><<<dim3(bt * h, nc, tmax + 1), OUT_THREADS, smem3,
                         stream>>>(xb, cc, dd, cb, scan, cstate,
                                   static_cast<bf16*>(y), state, s, h, g, n,
                                   chunk, qp, bc_sb, bc_st);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const float* dt, const float* a,
                        const void* bm, const void* cm, const float* dd,
                        void* y, float* state, float* cb, float* cstate,
                        float* scan, int bt, int s, int h, int p, int g,
                        int n, int chunk, long long bc_sb, long long bc_st,
                        cudaStream_t st) {
  if (n % 16 || n > TC_MAX_N || !cb || !cstate || !scan)
    return cudaErrorInvalidValue;
  switch (p) {
#define SSD_CASE(PV)                                                        \
  case PV:                                                                  \
    return launch_tc<PV>(x, dt, a, bm, cm, dd, y, state, cb, cstate, scan,  \
                         bt, s, h, g, n, chunk, bc_sb, bc_st, st);
    SSD_CASE(16)
    SSD_CASE(32)
    SSD_CASE(64)
    SSD_CASE(128)
#undef SSD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, y (bt, s, h, p); dt (bt, s, h) fp32; a, dd (bt, h) fp32; bm, cm
// (bt, s, g, n) with (batch, token) strides bc_sb, bc_st and a contiguous
// (g, n) block; state (bt, h, p, n) fp32.  is_bf16: 1 for bfloat16 x, y,
// bm, cm (the tensor-core kernels: p in {16, 32, 64, 128}, n a multiple of
// 16 up to 128, bf16 data and strides 16-byte aligned; fp32 scratch cb
// (bt, chunks, g, qp, qp) with qp = chunk rounded up to 64, cstate (bt, h,
// chunks, p, n) and scan (bt, h, chunks, 2, 256)); 0 for float32 (the
// CUDA-core kernel; the scratch pointers are not read).  Returns the CUDA
// error of the launches (0 = launched).
int ssd_scan_fwd(const void* x, const float* dt, const float* a,
                 const void* bm, const void* cm, const float* dd, void* y,
                 float* state, int bt, int s, int h, int p, int g, int n,
                 int chunk, long long bc_sb, long long bc_st, int is_bf16,
                 float* cb, float* cstate, float* scan, void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK || n < 1 || n > MAX_N || p % TP ||
      g < 1 || h % g || h > 65535 || bt > 65535)
    return cudaErrorInvalidValue;
  if (bt <= 0 || s <= 0 || h <= 0 || p <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch_bf16(x, dt, a, bm, cm, dd, y, state, cb, cstate, scan, bt, s,
                    h, p, g, n, chunk, bc_sb, bc_st, st)
      : launch(x, dt, a, bm, cm, dd, y, state, bt, s, h, p, g, n, chunk,
               bc_sb, bc_st, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
