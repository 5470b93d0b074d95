// Fused W-stack gossip on Hopper (sm_90a): T steps of x <- W_t @ x on a
// worker-stacked state x[N, D], the state kept on chip for the whole chain.
//
// Replaces the TPU kernels
//   K3  matcha_tpu/parallel/pallas_gossip.py: fused_gossip_run (:182)
//       -> _make_kernel (:156), pallas_call (:227)
//   K4  benchmarks/split_probe.py: run (:86) -> make_kernel(split) (:60),
//       pallas_call (:87)
//
// What it computes.  Step t, with W_t = stack[t] ([N, N], f32 or bf16, from
// build_mixing_stack, optionally composed):
//   x_i = state( sum_k W_t[i, k] * stackcast(x_k) )
// accumulated in f32.  stackcast rounds the state to the stack dtype at each
// step's input and state() rounds the f32 sum to the state dtype at its
// output, as the TPU kernel casts (:164-176).  The wrapper front-pads the
// stack with identity matrices to a multiple of w_window (:221-225); the
// kernels stage one W_t at a time, so w_window changes no bit here.  K4 is
// the same arithmetic on a bf16 state and stack; its split schedule only
// changes which threads wait for which.
//
// Two paths, picked by the stack's dtype:
//
// * f32 stack: FP32 FMA on CUDA cores (fused_gossip_kernel), never TF32,
//   which would change the result.  One CTA per column tile [N, tile]
//   loops over all T steps (the TPU kernel's sequential step axis becomes
//   this loop).  The tile sits in shared memory twice, "cur" and "next", as
//   f32: step t+1 reads every row of step t's result, so the write cannot
//   go in place.  Each thread accumulates an 8-row x 4-column register
//   block; a warp's lanes form RL = 128/tile row groups of 32/RL column
//   lanes, so per k a thread reads 8 W values as two float4 loads and 4
//   state values, then does 32 FMAs (__fmaf_rn: the port builds with
//   --fmad=false, which leaves the intrinsic alone).  Each step walks the
//   rows in passes of warps*RL*8 rows.  W_t streams through shared memory
//   in chunks of 8 k values, read along k into registers one chunk ahead
//   and stored transposed, one barrier per chunk.
//
// * bf16 stack: tensor cores (tc_gossip_kernel),
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 fed by ldmatrix, f32
//   accumulators in registers.  Every step rounds its input to bf16, so the
//   state tile is held in shared memory as bf16 (cur and next, half the
//   bytes of f32: N = 256 takes a 128-column tile in 128 KB); only the last
//   step needs the f32 sum, and it writes it from the accumulators straight
//   to device memory in the state's dtype.  A CTA has 8 warps, 4 along the
//   rows and 2 along the columns; a warp owns MT m16 tiles (MT = 1, 2 or 4
//   by N) times tile/16 columns, and a step walks the rows in passes of
//   64*MT.  Where N pads to 16 rows, one m16 tile, the 8 warps all lie
//   along the columns instead (tiles of 128, 256 or 512 columns), so no
//   warp idles and fewer, wider CTAs read W_t.  W_t streams in chunks of
//   [pass rows x 32 k] (two mma k steps) through a 3-slot ring filled by
//   cp.async, two chunks in flight, the next one requested behind each
//   chunk's products.  The state tile and
//   the W chunks are XOR-swizzled in 16-byte granules so ldmatrix reads
//   without bank conflicts.  N is zero-padded to a multiple of 16 in rows
//   and in k (the wrapper pads the stack; padded state rows stay zero and
//   are never written), and the ragged last column tile is zero-filled on
//   load and masked on store.  The template flag SPLIT is the schedule:
//     - unsplit (K3 on a bf16 stack): the CTA loads each W chunk once and
//       meets at one CTA-wide barrier per chunk (32 k values);
//     - split (K4): the two column halves of the tile belong to the two
//       halves of the warps (a column of W_t @ x reads only that column of
//       x).  Each half stages its own W chunks in its own ring and meets
//       only at its own named barrier (bar.sync 1 or 2, 128 threads), so
//       half 0 can cast and store step t while half 1 is still in its
//       products.  It reads every W_t from L2 twice as often.
//   Both schedules run each output element through the same mma sequence
//   (k chunks in order, the element at the same place of its m16n8 tile),
//   so split equals unsplit bitwise, and the tile width and the warps'
//   layout change no bit either.  The tensor cores' f32 sum need not round
//   like a chain of FMAs, so this path is held against the plain PyTorch
//   version to one bf16 ulp of the output, not bitwise.
//
// What bounds it (H100 SXM: 67 TFLOP/s FP32, 989 TFLOP/s bf16 dense, 3.35
// TB/s).  The work is 2*N^2*D*T operations; device memory is read and
// written once per element of x (2*N*D*bytes) whatever T is, plus the
// stack once.  For an f32 stack the FP32 rate bounds it.  For a bf16 stack
// the tensor-core rate is the bound (2.29 TFLOP at N = 256, D = 273,258,
// T = 64: 2.32 ms).  Each CTA re-reads the whole W_t from L2 every step,
// (D/tile)*T*N^2*2 B in all (17.9 GB at tile 128, N = 256, T = 64; twice
// that with SPLIT) -- the counterpart of the TPU kernel's
// (D/block_d)*T*N^2 (:17) -- so the wrapper takes the widest tile that
// fits the SM (two CTAs per SM on the FMA path, one on the tensor cores,
// whose 8 warps carry two W chunks in flight).  Measured on an H100
// (PERF.md), neither the tensor cores nor that L2 stream binds this
// mainloop at N = 256: it reaches a fifth of the tensor-core rate, and a
// 64-column tile, which reads W_t twice as often but fits two CTAs per SM,
// is faster.  Latency does, a barrier every 32 k values with 8 warps to
// hide it.  At small N a pass gives each barrier little work, so the
// kernel asks for two or three CTAs per SM there (__launch_bounds__),
// which caps its registers.  At N <= 16 every CTA reads the same 512 B of
// W_t each step; the wide tiles of the one-row-of-warps layout have
// fewer CTAs read it, which is faster for a long chain (256 columns from
// T = 8, 512 from T = 32, measured), while a short one goes faster over
// more, narrower CTAs.  The wrapper picks the tile from T.
//
// Shared memory: FMA 4*(2*8*(rows+4) + 2*N*tile) B, rows = 8*RL*min(8,
// ceil(N/(8*RL))); tensor cores 2*(rings*3*R*32 + 2*Npad*tile) B, R the
// rows of a pass (16*WM*MT), one ring unsplit, two split.  A CTA may use
// 227 KB, so N is bounded (at tile 32 about 840 on the FMA path, 1,400 on
// the tensor cores and 1,000 split); the wrapper rejects a larger N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSharedBytes = 232448;  // 227 KB per block on sm_90

template <typename T>
struct Dtype;

template <>
struct Dtype<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float round(float v) { return v; }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <>
struct Dtype<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// ------------------------------------------------ FMA path (f32 stack)

namespace fp32 {

constexpr int kRowsPerThread = 8;  // rows of a thread's register block
constexpr int kColsPerThread = 4;  // columns of a thread's register block
constexpr int kChunk = 8;          // k values of W_t staged at a time
constexpr int kPad = 4;  // floats after each k of the chunk: 4-way, not
                         // 32-way, bank conflicts on the transposing store
constexpr int kMaxWarps = 8;

// row groups per warp for a tile width: 32/rl column lanes x 4 columns
__host__ __device__ inline int row_groups(int tile) { return 128 / tile; }

__host__ __device__ inline int warps_for(int n, int tile) {
  const int per_warp = kRowsPerThread * row_groups(tile);
  const int w = (n + per_warp - 1) / per_warp;
  return w < kMaxWarps ? w : kMaxWarps;
}

__host__ __device__ inline size_t smem_bytes(int n, int tile) {
  const size_t rows = static_cast<size_t>(warps_for(n, tile)) *
                      kRowsPerThread * row_groups(tile);
  return sizeof(float) *
         (2 * kChunk * (rows + kPad) + 2 * static_cast<size_t>(n) * tile);
}

// One chunk of W_t (kChunk k values of the pass's rows): each of a CTA's
// threads loads `loads` values into registers, a warp reading consecutive
// k of one row (coalesced); `stash_chunk` stores them down the columns of
// the transposed chunk in shared memory.
template <int LOADS>
__device__ __forceinline__ void fetch_chunk(const float* __restrict__ w,
                                            int n, int row0, int k0,
                                            float (&reg)[LOADS]) {
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int e = threadIdx.x + l * blockDim.x;
    const int i = row0 + e / kChunk;
    const int k = k0 + e % kChunk;
    reg[l] = (i < n && k < n) ? w[static_cast<size_t>(i) * n + k] : 0.0f;
  }
}

template <int LOADS>
__device__ __forceinline__ void stash_chunk(const float (&reg)[LOADS],
                                            float* buf, int wstride) {
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int e = threadIdx.x + l * blockDim.x;
    buf[(e % kChunk) * wstride + e / kChunk] = reg[l];
  }
}

template <typename StateT, int RL>
__global__ void __launch_bounds__(kMaxWarps * 32)
    fused_gossip_kernel(const StateT* __restrict__ x, StateT* __restrict__ out,
                        const float* __restrict__ stack, int n, long long d,
                        int t_steps) {
  constexpr int kLanes = 32 / RL;                   // column lanes
  constexpr int kTile = kLanes * kColsPerThread;    // 128 / 64 / 32
  constexpr int kLoads = kChunk * kRowsPerThread * RL / 32;
  extern __shared__ __align__(16) float smem[];
  const int cl = threadIdx.x % kLanes;              // column lane
  const int rg = threadIdx.x / kLanes;              // row group in the CTA
  const int rows = (blockDim.x / kLanes) * kRowsPerThread;  // per pass
  const int wstride = rows + kPad;
  const int wsize = kChunk * wstride;
  float* wsm = smem;                                // [2][kChunk][wstride]
  float* cur = wsm + 2 * wsize;                     // [n][kTile]
  float* nxt = cur + static_cast<size_t>(n) * kTile;  // [n][kTile]
  const long long col0 = static_cast<long long>(blockIdx.x) * kTile;

  // The chain is a flat sequence of chunks q = ((t * passes) + p) * kchunks
  // + c: step t, row pass p, k chunk c.  Chunk q+1 waits in shared memory
  // and chunk q+2 in registers while chunk q is multiplied; (ft, fp, fc)
  // is the position of the next chunk to fetch.
  const int passes = (n + rows - 1) / rows;
  const int kchunks = (n + kChunk - 1) / kChunk;
  const long long q_total = static_cast<long long>(t_steps) * passes * kchunks;
  int ft = 0, fp = 0, fc = 0;
  auto fetch = [&](float (&reg)[kLoads]) {
    if (ft == t_steps) return;
    fetch_chunk(stack + static_cast<size_t>(ft) * n * n, n, fp * rows,
                fc * kChunk, reg);
    if (++fc == kchunks) {
      fc = 0;
      if (++fp == passes) {
        fp = 0;
        ++ft;
      }
    }
  };

  float pre[kLoads];
  fetch(pre);
  stash_chunk(pre, wsm, wstride);
  fetch(pre);
  for (int e = threadIdx.x; e < n * kTile; e += blockDim.x) {
    const int r = e / kTile;
    const long long col = col0 + e % kTile;
    cur[e] = col < d ? Dtype<StateT>::load(x + r * d + col) : 0.0f;
  }
  __syncthreads();

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.0f;
  }
  int t = 0, p = 0, c = 0;
  for (long long q = 0; q < q_total; ++q) {
    const int k0 = c * kChunk;
    const int klen = min(kChunk, n - k0);
    const float* wk = wsm + (q & 1) * wsize + rg * kRowsPerThread;
    const float* ck = cur + static_cast<size_t>(k0) * kTile + cl;
#pragma unroll 4
    for (int kk = 0; kk < klen; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(wk + kk * wstride);
      const float4 b = *reinterpret_cast<const float4*>(wk + kk * wstride + 4);
      const float wv[kRowsPerThread] = {a.x, a.y, a.z, a.w,
                                        b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float v = ck[kk * kTile + kLanes * j];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          acc[r][j] = __fmaf_rn(wv[r], v, acc[r][j]);
        }
      }
    }
    if (++c == kchunks) {  // the pass's rows are summed: write them
      c = 0;
      const bool last = t + 1 == t_steps;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = p * rows + rg * kRowsPerThread + r;
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const float s = Dtype<StateT>::round(acc[r][j]);
          acc[r][j] = 0.0f;
          if (i >= n) continue;
          if (last) {
            const long long col = col0 + cl + kLanes * j;
            if (col < d) Dtype<StateT>::store(out + i * d + col, s);
          } else {
            nxt[i * kTile + cl + kLanes * j] = s;
          }
        }
      }
      if (++p == passes) {  // the step is done: its result is the input
        p = 0;
        ++t;
        float* done = cur;
        cur = nxt;
        nxt = done;
      }
    }
    // the other buffer was last read in chunk q-1, before the last barrier
    if (q + 1 < q_total) {
      stash_chunk(pre, wsm + ((q + 1) & 1) * wsize, wstride);
    }
    fetch(pre);
    // chunk q+1 is stored, the rows written in this chunk are visible to
    // the next step, and cur is read no more before the step after
    // overwrites it
    __syncthreads();
  }
}

template <typename StateT, int RL>
cudaError_t launch(const void* x, void* out, const void* stack, int n,
                   long long d, int t_steps, cudaStream_t stream) {
  auto kernel = fused_gossip_kernel<StateT, RL>;
  constexpr int tile = 128 / RL;
  const size_t smem = smem_bytes(n, tile);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((d + tile - 1) / tile);
  kernel<<<blocks, warps_for(n, tile) * 32, smem, stream>>>(
      static_cast<const StateT*>(x), static_cast<StateT*>(out),
      static_cast<const float*>(stack), n, d, t_steps);
  return cudaGetLastError();
}

template <typename StateT>
cudaError_t dispatch(int tile, const void* x, void* out, const void* stack,
                     int n, long long d, int t_steps, cudaStream_t s) {
  switch (tile) {
    case 32:
      return launch<StateT, 4>(x, out, stack, n, d, t_steps, s);
    case 64:
      return launch<StateT, 2>(x, out, stack, n, d, t_steps, s);
    default:
      return launch<StateT, 1>(x, out, stack, n, d, t_steps, s);
  }
}

}  // namespace fp32

// --------------------------------------- tensor-core path (bf16 stack)

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHalfThreads = kThreads / 2;  // the split schedule's halves
constexpr int kK = 16;       // k values of one mma
constexpr int kStageK = 32;  // k values per W chunk: two mma k steps
constexpr int kStages = 3;   // W chunk slots per ring

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// warps along the rows: 4, or 1 when the padded N is a single m16 tile,
// so that all 8 warps hold columns instead of 6 of them idling
__host__ __device__ inline int warps_m(int n) {
  return pad16(n) <= 16 ? 1 : 4;
}

// m16 tiles per warp: a pass of 16*WM*MT rows, MT = 1, 2 or 4
__host__ __device__ inline int m_tiles(int n) {
  if (warps_m(n) == 1) return 1;
  const int m = (pad16(n) + 63) / 64;
  return m <= 1 ? 1 : (m == 2 ? 2 : 4);
}

// A warp holds NT = 2, 4 or 8 n8 tiles of columns, so a tile is 8/WM
// warps x 8 x NT columns: 32, 64 or 128 with 4 warps along the rows, 128,
// 256 or 512 with 1.  Returns NT, or 0 for a tile this N does not take.
__host__ __device__ inline int n_tiles(int n, int tile) {
  const int per_nt = kWarps / warps_m(n) * 8;
  const int nt = tile / per_nt;
  return tile % per_nt == 0 && (nt == 2 || nt == 4 || nt == 8) ? nt : 0;
}

__host__ __device__ inline size_t smem_bytes(int n, int tile, bool split) {
  const size_t ring = static_cast<size_t>(kStages) * 16 * warps_m(n) *
                      m_tiles(n) * kStageK;
  return sizeof(bf16) * ((split ? 2 : 1) * ring +
                         2 * static_cast<size_t>(pad16(n)) * tile);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// the CTA's barrier (unsplit) or the half's named barrier (split); ids 1
// and 2, as __syncthreads takes 0
template <bool SPLIT>
__device__ __forceinline__ void meet(int half) {
  if (SPLIT) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + half), "n"(kHalfThreads)
                 : "memory");
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element (k, c) of the [Npad][TILE] bf16 state tile.  The 16-byte
// granule c/8 is XORed with bits of the row, so the 8 rows of one
// ldmatrix (consecutive k, one granule) fall in 8 distinct bank groups.
template <int TILE>
__device__ __forceinline__ int state_idx(int k, int c) {
  constexpr int kGranules = TILE / 8;
  constexpr int kMask = kGranules < 8 ? kGranules - 1 : 7;
  constexpr int kShift = kGranules < 8 ? 1 : 0;  // TILE 32: rows 2 apart
  return k * TILE + (((c >> 3) ^ ((k >> kShift) & kMask)) << 3) + (c & 7);
}

// Element (r, g*8) of a [rows][32] W chunk: the four 16-byte granules of
// a row are XORed with bits 1-2 of the row, so an ldmatrix's 8 rows (one
// granule) hit 8 bank groups.
__device__ __forceinline__ int w_idx(int r, int g) {
  return r * kStageK + ((g ^ ((r >> 1) & 3)) << 3);
}

// CTAs an SM should hold: a short pass (small N) leaves the CTA's warps
// little work per barrier, so more CTAs hide its latency
template <int WM, int MT, int NT, bool SPLIT>
__global__ void __launch_bounds__(kThreads, MT == 4 ? 1 : (MT == 2 ? 2 : 3))
    tc_gossip_kernel(const void* __restrict__ x, void* __restrict__ out,
                     const bf16* __restrict__ stack, int n, long long d,
                     int t_steps, int state_bf16) {
  constexpr int WN = kWarps / WM;              // warps along the columns
  constexpr int TILE = WN * 8 * NT;
  constexpr int kPassRows = WM * MT * 16;
  constexpr int kSlot = kPassRows * kStageK;  // bf16 per W chunk
  constexpr int kRingThreads = SPLIT ? kHalfThreads : kThreads;
  constexpr int kRowStep = kRingThreads / 4;  // rows a fetch round copies
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  static_assert(WN % 2 == 0, "each split half holds whole warp columns");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int npad = pad16(n);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % WM;                  // row block of the warp
  const int wn = warp / WM;                  // column block of the warp
  const int half = warp / (kWarps / 2);      // column half: wn / (WN / 2)
  const int rt = SPLIT ? threadIdx.x % kHalfThreads : threadIdx.x;
  bf16* ring = smem + (SPLIT ? half * kStages * kSlot : 0);
  bf16* cur = smem + (SPLIT ? 2 : 1) * kStages * kSlot;   // [npad][TILE]
  bf16* nxt = cur + static_cast<size_t>(npad) * TILE;    // [npad][TILE]
  const long long col0 = static_cast<long long>(blockIdx.x) * TILE;

  // The chain is a flat sequence of chunks q = ((t * passes) + p) *
  // kchunks + c: step t, row pass p, 32-k chunk c.  (ft, fp, fc) is the
  // next chunk to fetch.  A thread copies 16-byte granule f_gran of rows
  // f_row, f_row + kRowStep, ...; the swizzle is the same for all of them.
  const int passes = (npad + kPassRows - 1) / kPassRows;
  const int kchunks = (npad + kStageK - 1) / kStageK;
  const long long q_total =
      static_cast<long long>(t_steps) * passes * kchunks;
  const int f_row = rt >> 2, f_gran = rt & 3;
  const int f_dst = w_idx(f_row, f_gran);
  int ft = 0, fp = 0, fc = 0;
  auto fetch = [&](int slot) {
    if (ft < t_steps) {
      const int row0 = fp * kPassRows;
      const int rows = min(kPassRows, npad - row0);
      const int k = fc * kStageK + f_gran * 8;
      if (k < npad) {  // the second half of the last chunk may not exist
        const bf16* src = stack +
                          (static_cast<size_t>(ft) * npad + row0 + f_row) *
                              npad + k;
        bf16* dst = ring + slot * kSlot + f_dst;
        for (int r = f_row; r < rows; r += kRowStep) {
          cp_async16(dst, src);
          src += static_cast<size_t>(kRowStep) * npad;
          dst += kRowStep * kStageK;
        }
      }
      if (++fc == kchunks) {
        fc = 0;
        if (++fp == passes) {
          fp = 0;
          ++ft;
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  // the state tile, rounded to bf16; padded rows and ragged columns are
  // zero in both buffers, and padded rows are never written again
  for (int e = threadIdx.x; e < npad * TILE; e += kThreads) {
    const int r = e / TILE, c = e % TILE;
    const long long col = col0 + c;
    float v = 0.0f;
    if (r < n && col < d) {
      const long long at = r * d + col;
      v = state_bf16 ? __bfloat162float(static_cast<const bf16*>(x)[at])
                     : static_cast<const float*>(x)[at];
    }
    cur[state_idx<TILE>(r, c)] = __float2bfloat16_rn(v);
    if (r >= n) nxt[state_idx<TILE>(r, c)] = __float2bfloat16_rn(0.0f);
  }
  __syncthreads();

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;
    }
  }
  // this lane's ldmatrix rows: A (W chunk) row lane%16, granule lane/16
  // of the 16-k step (its swizzle depends on the row's bits 1-2 only); B
  // (state) matrix lane/8 of an x4: k offset (lane/8 % 2)*8 + lane%8, n8
  // tile offset lane/16
  const int a_row = lane & 15, a_gran = lane >> 4;
  const int a_swz = (a_row >> 1) & 3;
  const int b_k = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_col = wn * NT * 8 + (lane >> 4) * 8;
  const int m_row0 = wm * MT * 16;  // the warp's first row in a pass

  int t = 0, p = 0, c = 0;
  for (long long q = 0; q < q_total; ++q) {
    cp_async_wait<kStages - 2>();  // this thread's part of chunk q landed
    meet<SPLIT>(half);             // all of chunk q; slot q-1 is free
    const bf16* w = ring + static_cast<int>(q % kStages) * kSlot;
#pragma unroll
    for (int s = 0; s < kStageK / kK; ++s) {
      const int k0 = c * kStageK + s * kK;
      if (k0 >= npad) break;
      uint32_t b[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        ldsm_x4_trans(b[j], cur + state_idx<TILE>(k0 + b_k, b_col + j * 16));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (p * kPassRows + m_row0 + i * 16 >= npad) continue;
        uint32_t a[4];
        ldsm_x4(a, w + (m_row0 + i * 16 + a_row) * kStageK +
                       (((2 * s + a_gran) ^ a_swz) << 3));
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          mma(acc[i][2 * j], a, b[j][0], b[j][1]);
          mma(acc[i][2 * j + 1], a, b[j][2], b[j][3]);
        }
      }
    }
    // refill the slot read in chunk q-1, behind this chunk's products
    fetch(static_cast<int>((q + kStages - 1) % kStages));
    if (++c == kchunks) {  // the pass's rows are summed: write them
      c = 0;
      const bool last = t + 1 == t_steps;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = wn * NT * 8 + j * 8 + 2 * (lane & 3);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = p * kPassRows + m_row0 + i * 16 + (lane >> 2) +
                          8 * hh;
            const float v0 = acc[i][j][2 * hh], v1 = acc[i][j][2 * hh + 1];
            acc[i][j][2 * hh] = 0.0f;
            acc[i][j][2 * hh + 1] = 0.0f;
            if (r >= n) continue;
            if (last) {
              const long long gc = col0 + col;
              const long long at = r * d + gc;
              if (state_bf16) {
                bf16* o = static_cast<bf16*>(out);
                if (gc < d) o[at] = __float2bfloat16_rn(v0);
                if (gc + 1 < d) o[at + 1] = __float2bfloat16_rn(v1);
              } else {
                float* o = static_cast<float*>(out);
                if (gc < d) o[at] = v0;
                if (gc + 1 < d) o[at + 1] = v1;
              }
            } else {
              *reinterpret_cast<__nv_bfloat162*>(
                  nxt + state_idx<TILE>(r, col)) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        }
      }
      if (++p == passes) {  // the step is done: its result is the input
        p = 0;
        ++t;
        bf16* done = cur;
        cur = nxt;
        nxt = done;
      }
    }
  }
  cp_async_wait<0>();
}

template <int WM, int MT, int NT, bool SPLIT>
cudaError_t launch(const void* x, void* out, const void* stack, int n,
                   long long d, int t_steps, int state_bf16,
                   cudaStream_t stream) {
  auto kernel = tc_gossip_kernel<WM, MT, NT, SPLIT>;
  constexpr int tile = kWarps / WM * 8 * NT;
  const size_t smem = smem_bytes(n, tile, SPLIT);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((d + tile - 1) / tile);
  kernel<<<blocks, kThreads, smem, stream>>>(
      x, out, static_cast<const bf16*>(stack), n, d, t_steps, state_bf16);
  return cudaGetLastError();
}

template <int WM, int MT, bool SPLIT>
cudaError_t dispatch_nt(int tile, const void* x, void* out,
                        const void* stack, int n, long long d, int t_steps,
                        int state_bf16, cudaStream_t s) {
  switch (n_tiles(n, tile)) {
    case 2:
      return launch<WM, MT, 2, SPLIT>(x, out, stack, n, d, t_steps,
                                      state_bf16, s);
    case 4:
      return launch<WM, MT, 4, SPLIT>(x, out, stack, n, d, t_steps,
                                      state_bf16, s);
    default:
      return launch<WM, MT, 8, SPLIT>(x, out, stack, n, d, t_steps,
                                      state_bf16, s);
  }
}

template <bool SPLIT>
cudaError_t dispatch(int tile, const void* x, void* out, const void* stack,
                     int n, long long d, int t_steps, int state_bf16,
                     cudaStream_t s) {
  if (warps_m(n) == 1) {
    return dispatch_nt<1, 1, SPLIT>(tile, x, out, stack, n, d, t_steps,
                                    state_bf16, s);
  }
  switch (m_tiles(n)) {
    case 1:
      return dispatch_nt<4, 1, SPLIT>(tile, x, out, stack, n, d, t_steps,
                                      state_bf16, s);
    case 2:
      return dispatch_nt<4, 2, SPLIT>(tile, x, out, stack, n, d, t_steps,
                                      state_bf16, s);
    default:
      return dispatch_nt<4, 4, SPLIT>(tile, x, out, stack, n, d, t_steps,
                                      state_bf16, s);
  }
}

}  // namespace tc

// path: 0 = FMA (f32 stack), 1 = tensor cores unsplit, 2 = tensor cores
// split.  Whether `path` takes `tile` columns at this n.
bool path_takes_tile(int n, int tile, int path) {
  return path == 0 ? (tile == 32 || tile == 64 || tile == 128)
                   : tc::n_tiles(n, tile) != 0;
}

size_t path_smem_bytes(int n, int tile, int path) {
  return path == 0 ? fp32::smem_bytes(n, tile)
                   : tc::smem_bytes(n, tile, path == 2);
}

}  // namespace

extern "C" {

// Shared memory one CTA of `path` needs at `tile` columns, in bytes (the
// wrapper picks the tile), or -1 if `path` does not take that tile at this
// n.  path: 0 = FMA (f32 stack; tiles 32, 64, 128), 1 = tensor cores, 2 =
// tensor cores with the split schedule (tiles 32, 64, 128; 128, 256, 512
// when n <= 16).
long long fused_gossip_smem_bytes(int n, int tile, int path) {
  if (n < 1 || path < 0 || path > 2 || !path_takes_tile(n, tile, path)) {
    return -1;
  }
  return static_cast<long long>(path_smem_bytes(n, tile, path));
}

long long fused_gossip_smem_limit() { return kMaxSharedBytes; }

// Run t_steps steps of x[n, d] <- stack[t] @ x into out[n, d] on `stream`,
// one CTA per `tile` columns (a tile fused_gossip_smem_bytes takes).
// state_dtype / stack_dtype: 0 = float32, 1 = bfloat16.  A float32 stack
// is [t_steps, n, n] and runs on the FMA path; a bfloat16 stack is
// [t_steps, npad, npad], npad = n rounded up to a multiple of 16 and
// zero-padded, and runs on the tensor cores, with the split schedule when
// `split` is 1.  Returns cudaGetLastError() after the launch (0 =
// cudaSuccess), or cudaErrorInvalidValue for arguments the kernels do not
// take.
int fused_gossip_launch(const void* x, void* out, const void* stack, int n,
                        long long d, int t_steps, int tile, int state_dtype,
                        int stack_dtype, int split, void* stream) {
  const int path = stack_dtype == 0 ? 0 : (split ? 2 : 1);
  if (n < 1 || d < 1 || t_steps < 1 ||
      (state_dtype != 0 && state_dtype != 1) ||
      (stack_dtype != 0 && stack_dtype != 1) || (split != 0 && split != 1) ||
      (split && stack_dtype != 1) || !path_takes_tile(n, tile, path) ||
      path_smem_bytes(n, tile, path) > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (path == 0) {
    err = state_dtype == 0
              ? fp32::dispatch<float>(tile, x, out, stack, n, d, t_steps, s)
              : fp32::dispatch<__nv_bfloat16>(tile, x, out, stack, n, d,
                                             t_steps, s);
  } else if (split) {
    err = tc::dispatch<true>(tile, x, out, stack, n, d, t_steps,
                             state_dtype, s);
  } else {
    err = tc::dispatch<false>(tile, x, out, stack, n, d, t_steps,
                              state_dtype, s);
  }
  return static_cast<int>(err);
}

const char* fused_gossip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
