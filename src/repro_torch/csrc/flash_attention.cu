// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_bhsd (body _flash_kernel).  On the TPU the grid walks the
// key blocks in order and carries the online-softmax state (m, l, acc) in
// VMEM scratch across grid steps.  Blocks on a GPU run in no order, so here
// ONE thread block owns one (q row, 32-query tile) and loops over the key
// tiles itself, keeping m, l and acc in fp32 registers; K/V tiles are
// staged in shared memory as fp32.
//
// Layout: q (BH, S, D), k/v (BHkv, S, D), heads-major; q row b reads kv row
// b / group (GQA by index, no head broadcast in memory).  Causal mask is
// top-left aligned (key index <= query index), as in the TPU kernel.  The
// ragged S edge is masked here, so the caller pads nothing.  A fully
// masked row divides by the 1e-20 clamp and comes out exactly 0.
//
// What bounds it: at the serving shapes (S <= 512, D = 64) the work is
// ~4*S^2/2*D*BH flops on CUDA cores in fp32 (no tensor cores) and the
// bytes are tiny, so it is compute-bound on the fp32 pipe, far from the
// bf16 tensor-core roofline.  The design keeps every score and
// probability on chip (no S x S matrix in device memory) and skips key
// tiles past the causal diagonal.  wgmma/TMA is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;                 // queries per block
constexpr int BK = 32;                 // keys per tile
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int group, int s, float scale,
                   cudaStream_t stream) {
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

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int bh, int group, int s, int d, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, bh, group, s, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, bh, group, s, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, group, s, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, group, s, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// is_bf16: 1 for bfloat16 tensors, 0 for float32.  Returns the CUDA error
// of the launch (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int bh, int group, int s, int d, float scale,
                        int is_bf16, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, bh, group, s, d,
                                           scale, st)
                 : dispatch<float>(q, k, v, o, bh, group, s, d, scale, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
