// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _kernel).  On the TPU one grid row is one (batch*head) stream, the chunk
// axis is the minor grid axis, and the (P, N) state lives in VMEM scratch
// from one grid step to the next.  Blocks on a GPU run in no order and
// carry nothing to each other, so here ONE thread block owns one stream
// (batch row, head) and a tile of TP = 16 of its P columns, and loops over
// the chunks itself with its (TP, N) state tile in shared memory.  This is
// exact: state row p and output column p depend only on x column p.  The
// split of P is what fills the card: the serving prefill has tp*B*H = 32
// streams of P = 64, i.e. 128 blocks on 132 SMs.
//
// Per chunk (csum = cumsum(dt * a) over the chunk's rows):
//   y_i   = sum_{j<=i} (C_i . B_j) exp(csum_i - csum_j) dt_j x_j
//         + exp(csum_i) C_i . state + D x_i
//   state = exp(csum_last) state + sum_j exp(csum_last - csum_j) dt_j x_j B_j^T
// The chunk's Q x Q score matrix does not fit in shared memory at Q = 256
// (256 KB in fp32), so 64-row query tiles walk the 64-row key tiles at or
// below them, forming C_i . B_j on the fly as a flash kernel forms Q K^T;
// there is no softmax, so nothing is rescaled.  Decays are always formed
// as exp of a DIFFERENCE of cumulative sums (every exponent is <= 0), never
// as a ratio of exps.
//
// Layout: x, y (Bt, S, H, P); dt (Bt, S, H) fp32; a, D (Bt, H) fp32; B and C
// (Bt, S, G, N) read at group h / (H / G) through their (batch, token)
// strides, so neither the G -> H broadcast nor a B/C split of the fused
// projection is materialised.  The final state is written as (Bt, H, P, N)
// fp32.  The ragged S edge is masked here (rows past S act as dt = 0 and
// x = 0, which leaves the outputs and the state exact), so the caller pads
// nothing.
//
// What bounds it: at the serving shapes the bytes are a few MB (1-2 us at
// 3.35 TB/s) and the useful work ~0.5 GFLOP per layer, but this simple
// kernel runs in fp32 on CUDA cores out of shared memory, and each of a
// stream's 4 column blocks recomputes the same C B^T scores (~75% of its
// multiply-adds).  It is therefore bound by shared-memory traffic of the
// score products, far from either roofline.  The 4x4 register tile of the
// score product halves the shared loads per multiply-add; wgmma on bf16
// tiles and sharing the scores across a stream's column blocks (a cluster)
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TP = 16;                 // P columns per block
constexpr int BT = 64;                 // rows per query / key tile
constexpr int THREADS = 256;
constexpr int MAX_CHUNK = THREADS;     // the cumsum gives one row per thread
constexpr int MAX_N = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int YR = THREADS / TP;       // 16: row stride of a thread's y rows
constexpr int SU = TP * MAX_N / THREADS;  // state entries per thread (max)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);            // round to nearest even
}

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

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* bm, const void* cm, const float* dd, void* y,
                   float* state, int bt, int s, int h, int p, int g, int n,
                   int chunk, long long bc_sb, long long bc_st,
                   cudaStream_t stream) {
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

}  // namespace

extern "C" {

// x, y (bt, s, h, p); dt (bt, s, h) fp32; a, dd (bt, h) fp32; bm, cm
// (bt, s, g, n) with (batch, token) strides bc_sb, bc_st and a contiguous
// (g, n) block; state (bt, h, p, n) fp32.  is_bf16: 1 for bfloat16 x, y,
// bm, cm; 0 for float32.  Returns the CUDA error of the launch (0 =
// launched).
int ssd_scan_fwd(const void* x, const float* dt, const float* a,
                 const void* bm, const void* cm, const float* dd, void* y,
                 float* state, int bt, int s, int h, int p, int g, int n,
                 int chunk, long long bc_sb, long long bc_st, int is_bf16,
                 void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK || n < 1 || n > MAX_N || p % TP ||
      g < 1 || h % g || h > 65535 || bt > 65535)
    return cudaErrorInvalidValue;
  if (bt <= 0 || s <= 0 || h <= 0 || p <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(x, dt, a, bm, cm, dd, y, state, bt, s, h, p, g,
                              n, chunk, bc_sb, bc_st, st)
      : launch<float>(x, dt, a, bm, cm, dd, y, state, bt, s, h, p, g, n,
                      chunk, bc_sb, bc_st, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
