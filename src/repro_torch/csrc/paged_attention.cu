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
// Chunks (C > 1: the warm suffix prefill today; chunked prefill and
// speculative verify later, at any position).  What bounds them: the warm
// suffix prefill of the serving path, q (2, 4, 32, 9, 64) bf16 with one live
// row at position 256, must read 288 visible keys of K and V (442 KB) and
// the live row's 32 query rows (74 KB; the empty slots' q is never read)
// and write all 295 KB of the output: 811 KB, 0.24 us at the memory rate,
// ~40 MFLOP.  Only 12
// (row, kv head, query tile) groups have work, 5 key tiles each, so the
// time is latency: one block walking a group's tiles in turn spends ~2.0
// us a tile on its math (one warp per SM partition, nothing to hide a
// dependent step behind) after ~3.5 us of fixed cost, 13.6 us in all on
// an H100 at 700 W; split over a cluster, 7.4 us
// (scripts/torch_paged_chunk_chain.py).
//
// bf16, paged_chunk_tc_kernel (B1's flash_fwd_tc_kernel, fed through the
// page table, its key tiles split over a cluster):
//   - a cluster of blocks per (row r, kv head h, 64-row query tile); the
//     g*C query rows that share h are packed (packed row x -> chunk row
//     x / g, q head h*g + x % g), so GQA's g = 3 fills mma rows; each of 4
//     warps owns 16 packed rows; the longest query tiles are scheduled
//     first;
//   - the table's key tiles of 64 logical keys (4 pages of 16) are split
//     over the cluster's min(8, tiles) blocks, from the table's width alone,
//     and each block's loop stops at the query tile's last visible key,
//     p0 + last / g: at the serving shape 5 blocks walk one tile each;
//   - each key's table entry is read one tile ahead of its copy (its
//     latency hides behind a tile's math) and published to shared memory
//     as a key-slot offset and a 64-bit visibility mask; each visible key's
//     row is gathered from its page by 16-byte cp.async into a ring of 2
//     K/V stages, keys of -1 pages are zero-filled without a read, and a
//     tile whose pages are all -1 moves no bytes and does no math; a
//     block's Q rows join the copies of its first tile with keys, so a
//     block that sees no key (every block of an empty slot) reads no Q;
//   - S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in, fp32
//     accumulate), fragments by ldmatrix (.trans for V); the online softmax
//     in fp32 registers with exp2 and the scale folded into log2 e; P is
//     rounded to bf16 as the A operand of P V; causal and -1-page masks per
//     packed row, applied only on tiles that need them;
//   - when more than one block has keys, each sends every row of its
//     partial (O in fp32, m, l) into the shared memory of the block that
//     merges that row (remote stores over distributed shared memory), and
//     after one cluster barrier each block merges its slice of the rows
//     from its own memory: one launch, no scratch in device memory, no
//     second kernel.  Distributed shared memory may be touched only once
//     the block that owns it has started: each block arrives (relaxed) at
//     the cluster barrier as it starts and waits on it just before its
//     remote stores, behind its key loop, where the wait costs ~nothing;
//   - a row with nothing visible keeps m = -inf and l = 0 and comes out 0
//     through the 1e-20 guard.
// Left for later: the decode's combine folded into its split kernel the
// same way (a cluster of the splits); the ~2 us from a block's start to
// its first tile (table entries and pos, then the gather) and the ~2 us
// the partial rows take to cross the cluster barrier; and the card holds
// 45 clusters of 8 at once, so the serving shape's 48 start in two waves.
//
// fp32 keeps paged_fwd_kernel (CUDA cores): ONE block owns (row, kv head
// h, a tile of up to 32 of the g*C query rows that share h) and loops over
// 32-key tiles, staging K and V in shared memory as fp32, with m, l and
// acc in fp32 registers, 4 threads per query row with shuffle reductions.
// Tensor cores in fp32 would mean TF32, which the fp32 tolerance (2e-5)
// forbids.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BQ = 32;                 // query rows per block
constexpr int BK = 32;                 // logical keys per tile
constexpr int TPR = 4;                 // threads per query row
constexpr int THREADS = BQ * TPR;      // 128
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
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

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const int* table, const int* pos, void* o, int tp,
                         int batch, int c, int hq, int hkv, int d, int ps,
                         int n, long long pool_stride, float scale,
                         cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<float, 16>(q, k, v, table, pos, o, tp, batch, c, hq, hkv,
                               ps, n, pool_stride, scale, stream);
    case 32:
      return launch<float, 32>(q, k, v, table, pos, o, tp, batch, c, hq, hkv,
                               ps, n, pool_stride, scale, stream);
    case 64:
      return launch<float, 64>(q, k, v, table, pos, o, tp, batch, c, hq, hkv,
                               ps, n, pool_stride, scale, stream);
    case 128:
      return launch<float, 128>(q, k, v, table, pos, o, tp, batch, c, hq,
                                hkv, ps, n, pool_stride, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Chunks in bf16: tensor cores, K/V gathered through the page table, the
// key tiles split over a cluster of blocks
// ---------------------------------------------------------------------------

constexpr int CQ = 64;                 // packed query rows per block: 4 x 16
constexpr int CK = 64;                 // logical keys per tile
constexpr int CMAX_SPLITS = 8;         // blocks per cluster (portable max)
constexpr int CSTAGES = 2;             // K/V tiles in the cp.async ring
constexpr int CSLOTS = CSTAGES + 1;    // published tiles: CSTAGES - 1 in
                                       // flight, one computed, one next
constexpr int CTHREADS = 128;
constexpr int CPAD = 8;                // bf16 per row: 16 bytes

// a received partial row: O[D] in fp32, then m, l and 2 floats of padding
// (16-byte rows for float4 reads)
template <int D>
__host__ __device__ constexpr int chunk_recv_stride() { return D + 4; }

template <int D>
constexpr int chunk_smem_bytes() {
  // Q, the K/V ring, then the partial rows this block merges: rb rows
  // from each of ns splits, ns * ceil(CQ / ns) < CQ + CMAX_SPLITS
  return (CQ + 2 * CSTAGES * CK) * (D + CPAD) * 2 +
         (CQ + CMAX_SPLITS) * chunk_recv_stride<D>() * 4;
}

// Fragment layouts: see mma_sm90.cuh.  The blocks of one (row r, kv head
// h, query tile) form a cluster of ns; block `split` walks key tiles
// [split * tps, (split + 1) * tps), tps = ceil(tiles of the table / ns), up
// to the tile's last visible key.  Within a block, local tile i is global
// tile t_begin + i: copy group i holds it (group 0 also Q); CSTAGES - 1
// groups are in flight before the loop and one more (maybe empty) is
// committed per tile.  Tile i's table entries are read (into `ent`,
// threads tid < CK, one key each) during the math of tile i - CSTAGES and
// published at its end into slot i % CSLOTS: koff (key slot phys * ps +
// key % ps, or -1) and kbits (bit j: key j of the tile is visible to some
// row of the block and its page is not -1).  When more than one block of
// the cluster has keys, each sends every row of its partial (unnormalised
// O, m, l) to the block that merges that row, into that block's shared
// memory (remote stores, distributed shared memory); after one cluster
// barrier every block merges its slice of the rows from its own memory.
template <int D>
__global__ void __launch_bounds__(CTHREADS)
paged_chunk_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ kpool,
                      const __nv_bfloat16* __restrict__ vpool,
                      const int* __restrict__ table,
                      const int* __restrict__ pos,
                      __nv_bfloat16* __restrict__ o, int batch, int c,
                      int hq, int hkv, int ps, int n, long long pool_stride,
                      float scale_log2) {
  constexpr int LD = D + CPAD;
  constexpr int CPR = D / 8;           // 16-byte chunks per row
  constexpr int DK = D / 16;           // k-steps of Q K^T over D
  constexpr int NS = CK / 8;           // 8-key column blocks of S
  constexpr int NO = D / 8;            // 8-column blocks of O
  static_assert(CK == 64 && CTHREADS >= CK, "two warps publish a tile");
  constexpr int RS = chunk_recv_stride<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + CQ * LD;    // CSTAGES x CK x LD
  __nv_bfloat16* vs = ks + CSTAGES * CK * LD;
  float* recv = reinterpret_cast<float*>(vs + CSTAGES * CK * LD);
  __shared__ int koff[CSLOTS][CK];
  __shared__ uint32_t kbits[CSLOTS][2];

  // every block arrives at the cluster barrier as it starts (relaxed: it
  // orders no memory); the wait before the remote stores below then
  // guarantees that every block they reach has started, as distributed
  // shared memory requires.  A cluster that takes the one-split exit
  // touches no other block's memory and never waits.
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int ns = (int)cluster.num_blocks();    // splits of the key tiles
  const int split = (int)cluster.block_rank();
  const int g = hq / hkv;
  const int rows = g * c;              // packed rows that share kv head h
  const int qt = gridDim.x / ns - 1 - blockIdx.x / ns;  // longest first
  const int x0 = qt * CQ;
  const int h = blockIdx.y;
  const int r = blockIdx.z;            // shard * batch + b
  const int shard = r / batch, b = r % batch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int* trow = table + (size_t)b * n;
  const int width = n * ps;            // logical keys the table maps
  // this split's key tiles, from the table's width alone
  const int tps = ((width + CK - 1) / CK + ns - 1) / ns;
  const int t_begin = split * tps;

  // the first tiles' table entries are requested beside pos[b]: neither
  // waits for the other
  int ent0[CSTAGES];
#pragma unroll
  for (int u = 0; u < CSTAGES; ++u) {
    const int kk = (t_begin + u) * CK + tid;
    ent0[u] = tid < CK && u < tps && kk < width ? trow[kk / ps] : -1;
  }
  const int p0 = pos[b];
  // keys past the tile's last row's position (or the table) are never
  // visible: the loops stop there
  const int last = min(x0 + CQ, rows) - 1;
  const int n_keys = min(width, p0 + last / g + 1);
  const int n_tiles = (n_keys + CK - 1) / CK;
  const int n_active = (n_tiles + tps - 1) / tps;  // splits with keys
  const int t_end = min(n_tiles, t_begin + tps);
  // one split has every key: it writes the output, the others have no
  // part (uniform over the cluster, so no barrier is left waiting)
  if (n_active == 1 && split > 0) return;

  const __nv_bfloat16* kbase = kpool + shard * pool_stride + h * D;
  const __nv_bfloat16* vbase = vpool + shard * pool_stride + h * D;
  const __nv_bfloat16* qg = q + (size_t)r * c * hq * D;

  // threads tid < CK (warps 0 and 1, whole warps) publish local tile i
  auto publish = [&](int i, int ent) {
    const int kk = (t_begin + i) * CK + tid;
    const bool ok = ent >= 0 && kk < n_keys;
    koff[i % CSLOTS][tid] = ok ? ent * ps + kk % ps : -1;
    const uint32_t bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) kbits[i % CSLOTS][warp] = bits;
  };
  // every thread: gather local tile i's visible K/V rows into ring stage
  // i % CSTAGES (zero-filled rows for keys of -1 pages); a tile with no
  // visible key copies nothing.  The tile's packed Q rows (rows past g*C
  // zero-filled) join the first copy group with keys: a block that sees
  // no key (an empty slot's) reads no Q either.  q_copied is uniform over
  // the block (it follows kbits, in shared memory).
  bool q_copied = false;
  auto issue = [&](int i) {
    const int sl = i % CSLOTS;
    if (t_begin + i >= t_end || !(kbits[sl][0] | kbits[sl][1])) return;
    if (!q_copied) {
      q_copied = true;
      for (int e = tid; e < CQ * CPR; e += CTHREADS) {
        const int rr = e / CPR, col = (e % CPR) * 8;
        const int x = x0 + rr;
        const bool ok = x < rows;
        cp_async16(qs + rr * LD + col,
                   ok ? qg + ((size_t)(x / g) * hq + h * g + x % g) * D + col
                      : qg,
                   ok);
      }
    }
    __nv_bfloat16* kd = ks + (i % CSTAGES) * CK * LD;
    __nv_bfloat16* vd = vs + (i % CSTAGES) * CK * LD;
#pragma unroll
    for (int e = tid; e < CK * CPR; e += CTHREADS) {
      const int key = e / CPR, col = (e % CPR) * 8;
      const int slot = koff[sl][key];
      const bool ok = slot >= 0;
      const size_t off = (size_t)(ok ? slot : 0) * hkv * D + col;
      cp_async16(kd + key * LD + col, kbase + off, ok);
      cp_async16(vd + key * LD + col, vbase + off, ok);
    }
  };

  if (tid < CK) {
#pragma unroll
    for (int u = 0; u < CSTAGES; ++u) publish(u, ent0[u]);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < CSTAGES - 1; ++u) {
    issue(u);
    cp_async_commit();
  }

  // this warp's rows; a warp whose 16 rows are all past g*C only copies
  const bool warp_live = x0 + warp * 16 < rows;
  int qpos[2];                         // -1: a padding row sees nothing
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int x = x0 + warp * 16 + gid + hh * 8;
    qpos[hh] = x < rows ? p0 + x / g : -1;
  }
  uint32_t qf[DK][4];
  bool q_loaded = false;               // qf holds Q (from the first tile
  float oacc[NO][4];                   // with keys on)
#pragma unroll
  for (int j = 0; j < NO; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max (log2 units)
  float l[2] = {0.f, 0.f};               // this lane's part of the sum

  for (int i = 0; t_begin + i < t_end; ++i) {
    cp_async_wait<CSTAGES - 2>();      // tile i has landed (this thread's
    __syncthreads();                   // part; the barrier: everyone's)
    // refill the stage that tile i - 1 used: every thread is past it
    issue(i + CSTAGES - 1);
    cp_async_commit();
    // the table entry of tile i + CSTAGES: in flight during this tile
    const int kn = (t_begin + i + CSTAGES) * CK + tid;
    const int ent = tid < CK && t_begin + i + CSTAGES < t_end &&
                    kn < n_keys ? trow[kn / ps] : -1;

    const int sl = i % CSLOTS;
    const uint32_t b0 = kbits[sl][0], b1 = kbits[sl][1];
    const int k0 = (t_begin + i) * CK;
    if ((b0 | b1) && warp_live) {
      if (!q_loaded) {                 // Q landed with this tile's group
        q_loaded = true;
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          const int rr = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(qf[kk], qs + rr * LD + kk * 16 + (lane >> 4) * 8);
        }
      }
      const __nv_bfloat16* kb = ks + (i % CSTAGES) * CK * LD;
      const __nv_bfloat16* vb = vs + (i % CSTAGES) * CK * LD;
      float sacc[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
        for (int j = 0; j < NS; j += 2) {  // 16 keys per ldmatrix
          uint32_t bf[4];
          const int key = j * 8 + (lane & 7) + (lane >> 4) * 8;
          ldmatrix_x4(bf, kb + key * LD + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(sacc[j], qf[kk], bf[0], bf[1]);
          mma_bf16(sacc[j + 1], qf[kk], bf[2], bf[3]);
        }
      }
      // masks only where a key is invisible to some row of this warp (a
      // -1 page, past the table, or past the warp's first row's position);
      // padding rows past g*C are never written, so they need none
      const bool need = (b0 & b1) != 0xffffffffu ||
                        k0 + CK - 1 > p0 + (x0 + warp * 16) / g;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sv = sacc[j][e] * scale_log2;
          if (need) {
            const int kl = j * 8 + 2 * tig + (e & 1);
            const uint32_t bits = kl < 32 ? b0 : b1;
            if (!((bits >> (kl & 31)) & 1u) || k0 + kl > qpos[e >> 1])
              sv = -INFINITY;
          }
          sacc[j][e] = sv;
        }
      }

#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {   // rows gid and gid + 8
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(sacc[j][2 * hh], sacc[j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        // a row with nothing visible yet keeps m = -inf: exp2(-inf) = 0
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[hh] - m_use);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float e0 = exp2f(sacc[j][2 * hh] - m_use);
          const float e1 = exp2f(sacc[j][2 * hh + 1] - m_use);
          sacc[j][2 * hh] = e0;
          sacc[j][2 * hh + 1] = e1;
          rs += e0 + e1;
        }
        l[hh] = l[hh] * corr + rs;
        m[hh] = m_new;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          oacc[j][2 * hh] *= corr;
          oacc[j][2 * hh + 1] *= corr;
        }
      }

      // O += P V: the S accumulators of keys 16kk..16kk+15 are the A
      // fragment of k-step kk, rounded to bf16
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
        pa[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
        pa[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
        pa[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < NO; j += 2) {  // 16 output columns per ldmatrix
          uint32_t bf[4];
          const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(bf, vb + key * LD + j * 8 + (lane >> 4) * 8);
          mma_bf16(oacc[j], pa, bf[0], bf[1]);
          mma_bf16(oacc[j + 1], pa, bf[2], bf[3]);
        }
      }
    }
    // slot (i + CSTAGES) % CSLOTS is tile i - 1's: every thread is past it
    if (tid < CK) publish(i + CSTAGES, ent);
  }
  cp_async_wait<0>();                  // no copy outlives the loop

  float lt[2];                         // the rows' sums over the quad
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lt[hh] = l[hh];
    lt[hh] += __shfl_xor_sync(0xffffffffu, lt[hh], 1);
    lt[hh] += __shfl_xor_sync(0xffffffffu, lt[hh], 2);
  }
  auto out_row = [&](int x) {          // packed row x's output, in o
    return o + (((size_t)r * c + x / g) * hq + h * g + x % g) * D;
  };

  // outputs are O * (1 / max(l, 1e-20)): one division a row, and never
  // 0 / 1e-20, which takes the IEEE division's slow path (~5 us a block
  // for a row with nothing visible, as every row of an empty slot is)
  if (n_active == 1) {                 // every key was this block's
    if (!warp_live) return;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float inv = 1.f / fmaxf(lt[hh], 1e-20f);
      const int x = x0 + warp * 16 + gid + hh * 8;
      if (x < rows) {
        __nv_bfloat16* og = out_row(x) + 2 * tig;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(og + j * 8) =
              __floats2bfloat162_rn(oacc[j][2 * hh] * inv,
                                    oacc[j][2 * hh + 1] * inv);
        }
      }
    }
    return;
  }

  // this split sends row `row` of its partial to block row / rb, which
  // keeps split s's rows at recv[s * rb + row % rb]; a split with no keys
  // sends nothing and is not read
  const int rb = (CQ + ns - 1) / ns;   // rows each block merges
  // every block of the cluster has started (its arrival is at its top)
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  if (warp_live && t_begin < t_end) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = warp * 16 + gid + hh * 8;
      float* dst = cluster.map_shared_rank(recv, row / rb) +
                   (split * rb + row % rb) * RS;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        *reinterpret_cast<float2*>(dst + j * 8 + 2 * tig) =
            make_float2(oacc[j][2 * hh], oacc[j][2 * hh + 1]);
      }
      if (tig == 0) *reinterpret_cast<float2*>(dst + D) =
          make_float2(m[hh], lt[hh]);
    }
  }
  cluster.sync();                      // every partial row has arrived
  // merge rows [r0, r1) of the tile from the n_active partials, 4 columns
  // a thread: weights exp2(m_s - M), M the row's largest m (0 when no
  // split saw a key, so that the row comes out 0)
  const int r0 = split * rb, r1 = min(CQ, r0 + rb);
  for (int e = tid; e < (r1 - r0) * (D / 4); e += CTHREADS) {
    const int lr = e / (D / 4), col = (e % (D / 4)) * 4;
    const int x = x0 + r0 + lr;
    if (x >= rows) continue;
    float mx = -INFINITY;
    for (int sp = 0; sp < n_active; ++sp)
      mx = fmaxf(mx, recv[(sp * rb + lr) * RS + D]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float den = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < n_active; ++sp) {
      const float* src = recv + (sp * rb + lr) * RS;
      const float w = exp2f(src[D] - m_use);
      const float4 v = *reinterpret_cast<const float4*>(src + col);
      den += w * src[D + 1];
      a.x += w * v.x;
      a.y += w * v.y;
      a.z += w * v.z;
      a.w += w * v.w;
    }
    const float inv = 1.f / fmaxf(den, 1e-20f);
    __nv_bfloat162 lo = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    __nv_bfloat162 hi = __floats2bfloat162_rn(a.z * inv, a.w * inv);
    *reinterpret_cast<uint2*>(out_row(x) + col) =
        make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                   *reinterpret_cast<uint32_t*>(&hi));
  }
}

template <int D>
cudaError_t launch_chunk_tc(const void* q, const void* k, const void* v,
                            const int* table, const int* pos, void* o,
                            int tp, int batch, int c, int hq, int hkv, int ps,
                            int n, long long pool_stride, float scale,
                            cudaStream_t stream) {
  constexpr int smem = chunk_smem_bytes<D>();
  // the table's key tiles split over clusters of up to CMAX_SPLITS blocks
  const int n_splits = min(CMAX_SPLITS, (n * ps + CK - 1) / CK);
  cudaError_t err = cudaFuncSetAttribute(
      paged_chunk_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int g = hq / hkv;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g * c + CQ - 1) / CQ * n_splits, hkv, tp * batch);
  cfg.blockDim = dim3(CTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, paged_chunk_tc_kernel<D>, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), table, pos,
      static_cast<__nv_bfloat16*>(o), batch, c, hq, hkv, ps, n, pool_stride,
      scale * 1.4426950408889634f);
}

cudaError_t dispatch_chunk_tc(const void* q, const void* k, const void* v,
                              const int* table, const int* pos, void* o,
                              int tp, int batch, int c, int hq, int hkv,
                              int d, int ps, int n, long long pool_stride,
                              float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_chunk_tc<16>(q, k, v, table, pos, o, tp, batch, c, hq,
                                 hkv, ps, n, pool_stride, scale, stream);
    case 32:
      return launch_chunk_tc<32>(q, k, v, table, pos, o, tp, batch, c, hq,
                                 hkv, ps, n, pool_stride, scale, stream);
    case 64:
      return launch_chunk_tc<64>(q, k, v, table, pos, o, tp, batch, c, hq,
                                 hkv, ps, n, pool_stride, scale, stream);
    case 128:
      return launch_chunk_tc<128>(q, k, v, table, pos, o, tp, batch, c, hq,
                                  hkv, ps, n, pool_stride, scale, stream);
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
// the pools; is_bf16: 1 for bfloat16 tensors (tensor-core kernel; q and the
// pools, and the shard stride in bytes, 16-byte aligned; its key tiles are
// split over clusters of min(8, ceil(n*ps / 64)) blocks), 0 for float32
// (CUDA-core kernel).  Returns the CUDA error of the launch (0 = launched).
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
  if (!is_bf16)
    return dispatch_f32(q, k, v, t, p, o, tp, batch, c, hq, hkv, d, ps, n,
                        pool_stride, scale, st);
  return dispatch_chunk_tc(q, k, v, t, p, o, tp, batch, c, hq, hkv, d, ps, n,
                           pool_stride, scale, st);
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
