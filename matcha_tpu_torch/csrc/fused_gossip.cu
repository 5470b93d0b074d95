// Fused W-stack gossip on Hopper (sm_90a): T steps of x <- W_t @ x on a
// worker-stacked state x[N, D], the state kept on chip for the whole chain
// (one launch per step at large N, the state in device memory).
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
// kernels never see w_window, so it changes no bit here.  K4 is the same
// arithmetic on a bf16 state and stack; its split schedule only changes
// which threads wait for which.  Column c of W_t @ x reads only column c
// of x, so a column's whole chain runs in one CTA (the TPU kernel's
// sequential step axis becomes a loop; Hopper CTAs run in no order).
//
// Seven paths.  The wrapper picks one from N and the stack's dtype alone
// (the state's dtype never changes the path), and never retries another:
//
// * FMA with the columns in registers (fma_regs_gossip_kernel): an f32
//   stack and N <= 16.  A thread owns one pair of columns of all N rows,
//   padded to NR = 8 or 16, in registers for all T steps, plus a second
//   register copy for the step's sums: device memory is read once and
//   written once, with no barrier between steps.  W_t is staged transposed
//   in shared memory (wsm[t][k][i] = W_t[i, k]), so each k is NR/4
//   broadcast LDS.128 feeding 2*NR FMAs.  The sums are the unbroken chain
//   acc = __fmaf_rn(W[i,k], x[k], acc) from +0, k = 0 .. N-1 in order, as
//   on the other FMA paths, so all give the same bits.
// * Tensor cores chained in registers (tc_regs_gossip_kernel): a bf16
//   stack and N <= 16 (padded to 16).  A warp runs the transposed product
//   x^T <- x^T W_t^T with mma.sync.m16n8k16 (A = 16 columns x 16 workers
//   of the state, B = W_t^T as two n8 tiles); the two accumulators of a
//   step, rounded to bf16 pairs, are the next step's A fragment with no
//   shuffle, so a warp carries its 32 columns through all T steps in
//   registers, with no barrier.  The state enters through a per-warp
//   staging buffer filled by cp.async one item ahead (ldmatrix.trans
//   reads the A fragments out of it) and the last step's f32 sums leave
//   through it, so device memory sees whole rows of the warp's columns.
//   The stack is staged permuted, one LDS.128 of B fragments per lane and
//   step.
// Both register paths run a persistent grid (as many CTAs as fit the
// card), which walks the columns round-robin.
// * The FMA chain (fma_chain_kernel): an f32 stack and 16 < N <= 256.
//   One CTA of 256 threads per column tile [N, tile] runs all T steps.  A
//   thread sums an 8 x 8 register block (rows 8g..8g+7, columns {4l..,
//   tile/2+4l..}), so the CTA holds 16,384 sums: one whole step of
//   R = 32, 64, 128 or 256 rows (>= N) by tile = 512, 256, 128 or 64
//   columns.  The
//   state tile therefore sits in shared memory once, as f32: when every
//   thread has read it (one barrier) the step's sums overwrite it in place.
//   Per k a thread reads W as two LDS.128 (broadcast in a quarter warp) and
//   the state as two LDS.128 (8 consecutive granules a quarter warp), then
//   does 64 FMAs.  W_t^T comes from a transposed copy of the stack
//   (transpose_stack, once per chain, [t][k][R] with rows past N zero) in
//   stages of 16 k values (32 where R <= 64) through a 3-stage ring filled
//   by cp.async two stages ahead, one barrier per stage.
// * FMA one launch per step (fma_step_kernel): an f32 stack and N > 256.
//   The state stays in device memory, ping-ponging two buffers; each step
//   is a tiled product of [128 x 128] output tiles (16 x 16 threads of the
//   same 8 x 8 blocks), W_t^T (the transposed copy) and the state staged in
//   8-k stages through registers into shared memory.  No split-K.
// Every FMA path sums each element as the unbroken chain acc = fma(W[i,k],
// x[k], acc) from +0, k = 0 .. N-1 in order, never multiplying a padded k,
// so all three give the same bits.
// * Tensor cores in shared memory (tc_gossip_kernel): a bf16 stack and
//   16 < N <= 1024, unsplit (K3), or split (K4).
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 fed by ldmatrix, f32
//   accumulators in registers.  Every step rounds its input to bf16, so the
//   state tile is held in shared memory as bf16 (cur and next, half the
//   bytes of f32: N = 256 takes a 128-column tile in 128 KB); only the last
//   step needs the f32 sum, and it writes it from the accumulators straight
//   to device memory in the state's dtype.  A CTA has 8 warps, 4 along the
//   rows and 2 along the columns; a warp owns MT m16 tiles (MT = 1, 2 or 4
//   by N) times tile/16 columns, and a step walks the rows in passes of
//   64*MT.  W_t streams in chunks of [pass rows x 32 k] (two mma k steps)
//   through a 3-slot ring filled by cp.async, two chunks in flight, the
//   next one requested behind each chunk's products.  The state tile and
//   the W chunks are XOR-swizzled in 16-byte granules so ldmatrix reads
//   without bank conflicts.  N is zero-padded to a multiple of 16 in rows
//   and in k (the wrapper pads the stack; padded state rows stay zero and
//   are never written), and the ragged last column tile is zero-filled on
//   load and masked on store.  The template flag SPLIT is the schedule:
//     - unsplit (K3 on a bf16 stack): the CTA loads each W chunk once and
//       meets at one CTA-wide barrier per chunk (32 k values);
//     - split (K4): the two column halves of the tile belong to the two
//       halves of the warps.  Each half stages its own W chunks in its own
//       ring and meets only at its own named barrier (bar.sync 1 or 2, 128
//       threads), so half 0 can cast and store step t while half 1 is
//       still in its products.  It reads every W_t from L2 twice as often.
//   Both schedules run each output element through the same mma sequence
//   (k chunks in order, the element at the same place of its m16n8 tile),
//   so split equals unsplit bitwise, and the tile width changes no bit
//   either.  The tensor cores' f32 sum need not round like a chain of
//   FMAs, so the bf16 paths are held against the plain PyTorch version to
//   one bf16 ulp of the output, not bitwise.
// * Tensor cores one launch per step (tc_step_kernel): a bf16 stack and
//   N > 1024.  The state stays in device memory; each step is a tiled
//   product of [128 x 64] output tiles whose W and state chunks (32 k) go
//   through the mainloop's swizzled layouts and the same ldmatrix/mma
//   sequence per element, so it equals the shared-memory path bitwise.
//
// What bounds it (H100 SXM: 67 TFLOP/s FP32, 989 TFLOP/s bf16 dense, 3.35
// TB/s).  The work is 2*N^2*D*T operations; device memory is read and
// written once per element of x (2*N*D*bytes) whatever T is, plus the
// stack once.  At N = 16, D = 273,258 a short chain is bound by those bytes
// (10.4 us at T = 1 for an f32 state), which the register paths move once
// with no barrier in the way and the stack a few KB of shared memory.  A
// long f32 chain is bound by the FP32 rate (0.134 ms at T = 64, 34.2 ms at
// N = 256), where the register path spends NR/4 LDS.128 per 2*NR FMAs and
// the FMA chain 4 LDS.128 per 64; a long bf16 chain by the tensor cores,
// where the register path spends an LDS.128, 4 mma and 8 packs per 32
// columns and step.  On the shared-memory paths each CTA re-reads the
// whole W_t from L2 every step, (D/tile)*T*N^2 elements in all -- the
// counterpart of the TPU kernel's (D/block_d)*T*N^2 (:17) -- so the wider
// the tile the better: the FMA chain takes the widest its 16,384 register
// sums allow.  The per-step paths add a read and a write of the state per
// step (2*N*D*bytes, 0.33 ms at N = 512 in f32) to a product of 2*N^2*D
// operations (2.1 ms), which the card overlaps across CTAs.  Measured
// times: PERF.md.
//
// Shared memory: the FMA chain 4*(N*tile + 3*K*R) B, K = 32 for R <= 64
// else 16 (at most 112 KB: two CTAs per SM); the per-step FMA kernel 16
// KB, the per-step tensor cores 24 KB (static); the tensor cores'
// mainloop 2*(rings*3*R*32 + 2*Npad*tile) B, R the rows of a pass (64*MT),
// one ring unsplit, two split.  A CTA may
// use 227 KB, so that mainloop is bounded (at tile 32 about 1,424 workers,
// 1,000 split); the wrapper sends N > 1024 one step at a time, and the
// split probe keeps its cap.  Device memory the wrapper allocates per call
// (fused_gossip_scratch_bytes): the transposed f32 stack (FMA chain and
// per-step FMA) and the states between steps (per-step paths).  The
// register paths: the staged stack, at most 64 KB (window steps of
// 4*NR^2 or 512 B), plus two 2,304 B staging buffers per warp on the
// tensor cores.  Their grid comes from the occupancy API once per kernel,
// device and shared memory, and is kept (card_ctas): a launch sets no
// attribute after the first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kMaxSharedBytes = 232448;  // 227 KB per block on sm_90

template <typename T>
struct Dtype;

template <>
struct Dtype<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static float round(float v) { return v; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Dtype<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// Columns (col, col + 1) of row r as f32, zero past d: one pair access
// where `vec` says every row's pair is aligned (even d), else scalars.
template <typename StateT>
__device__ __forceinline__ float2 load_pair(const StateT* __restrict__ x,
                                            long long r, long long d,
                                            long long col, int vec) {
  const StateT* p = x + r * d + col;
  if (vec && col + 1 < d) return Dtype<StateT>::load2(p);
  return make_float2(col < d ? Dtype<StateT>::load(p) : 0.0f,
                     col + 1 < d ? Dtype<StateT>::load(p + 1) : 0.0f);
}

template <typename StateT>
__device__ __forceinline__ void store_pair(StateT* __restrict__ out,
                                           long long r, long long d,
                                           long long col, int vec, float a,
                                           float b) {
  StateT* p = out + r * d + col;
  if (vec && col + 1 < d) {
    Dtype<StateT>::store2(p, a, b);
    return;
  }
  if (col < d) Dtype<StateT>::store(p, a);
  if (col + 1 < d) Dtype<StateT>::store(p + 1, b);
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

// ------------------------------------------------ FMA paths (f32 stack)

namespace fp32 {

constexpr int kThreads = 256;
constexpr int kBlock = 8;                                // 8 x 8 per thread
constexpr int kOutputs = kThreads * kBlock * kBlock;     // 16,384 per CTA
// k values of W_t^T per ring stage of the chain: 32 where a step has at
// most 64 rows of sums (fewer barriers per step at small N), else 16
// (three stages and the state tile then leave room for two CTAs per SM)
__host__ __device__ constexpr int stage_k(int rows) {
  return rows <= 64 ? 32 : 16;
}
constexpr int kStages = 3;   // ring stages (chain)
constexpr int kStepRows = 128, kStepCols = 128;  // a step CTA's tile
constexpr int kStepK = 8;    // k values per stage (step)

// The chain's launch shape: `tile` columns (512, 256, 128 or 64) and
// kOutputs / tile rows (32, 64, 128 or 256), the rows of one step's sums.
__host__ __device__ inline int chain_rows(int tile) { return kOutputs / tile; }

__host__ __device__ inline bool chain_takes(int n, int tile) {
  return (tile == 64 || tile == 128 || tile == 256 || tile == 512) &&
         n <= chain_rows(tile);
}

__host__ __device__ inline size_t chain_smem_bytes(int n, int tile) {
  return sizeof(float) * (static_cast<size_t>(n) * tile +
                          static_cast<size_t>(kStages) *
                              stage_k(chain_rows(tile)) * chain_rows(tile));
}

__host__ __device__ inline int step_ldw(int n) {
  return (n + kStepRows - 1) / kStepRows * kStepRows;
}

// wt[t][k][i] = w[t][i][k] for i < n, 0 for n <= i < ldw (k < n): the
// stack transposed once per chain, each k a contiguous row of ldw floats,
// so a ring stage is a straight 16-byte copy already in the [k][rows]
// layout the register blocks read.  32 x 32 tiles through shared memory
// (padded against bank conflicts), coalesced on both sides.
__global__ void transpose_stack(const float* __restrict__ w,
                                float* __restrict__ wt, int n, int ldw,
                                int t_steps) {
  __shared__ float tile[32][33];
  const int i0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int t = blockIdx.z; t < t_steps; t += gridDim.z) {
    const float* src = w + static_cast<size_t>(t) * n * n;
    float* dst = wt + static_cast<size_t>(t) * n * ldw;
    for (int r = threadIdx.y; r < 32; r += blockDim.y) {
      const int i = i0 + r, k = k0 + threadIdx.x;
      tile[r][threadIdx.x] =
          i < n && k < n ? src[static_cast<size_t>(i) * n + k] : 0.0f;
    }
    __syncthreads();
    for (int r = threadIdx.y; r < 32; r += blockDim.y) {
      const int k = k0 + r, i = i0 + threadIdx.x;
      if (k < n && i < ldw) {
        dst[static_cast<size_t>(k) * ldw + i] = tile[threadIdx.x][r];
      }
    }
    __syncthreads();
  }
}

// One k of a thread's 8 x 8 block: rows 8g .. 8g+7 of W^T row `wk` (wk
// points at 8g) and columns {4l.., HC+4l..} of state row `xk` (xk points
// at 4l): 4 LDS.128, 64 FMAs, each the next link of its element's chain
// acc = fma(W[i,k], x[k], acc).
template <int HC>
__device__ __forceinline__ void fma_k(float (&acc)[kBlock][kBlock],
                                      const float* wk, const float* xk) {
  const float4 w0 = *reinterpret_cast<const float4*>(wk);
  const float4 w1 = *reinterpret_cast<const float4*>(wk + 4);
  const float4 x0 = *reinterpret_cast<const float4*>(xk);
  const float4 x1 = *reinterpret_cast<const float4*>(xk + HC);
  const float wv[kBlock] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const float xv[kBlock] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
  for (int r = 0; r < kBlock; ++r) {
#pragma unroll
    for (int c = 0; c < kBlock; ++c) {
      acc[r][c] = __fmaf_rn(wv[r], xv[c], acc[r][c]);
    }
  }
}

// The thread's 8 x 8 block to device memory: rows row0 + 8g + r, columns
// col0 + {4l.., HC+4l..}, as pairs where `vec`.
template <typename StateT, int HC>
__device__ __forceinline__ void store_block(StateT* __restrict__ out,
                                            const float (&acc)[kBlock][kBlock],
                                            int n, long long d, int row0,
                                            long long col0, int g, int l,
                                            int vec) {
#pragma unroll
  for (int r = 0; r < kBlock; ++r) {
    const int i = row0 + 8 * g + r;
    if (i >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long col = col0 + h * HC + 4 * l;
      store_pair(out, i, d, col, vec, acc[r][4 * h], acc[r][4 * h + 1]);
      store_pair(out, i, d, col + 2, vec, acc[r][4 * h + 2],
                 acc[r][4 * h + 3]);
    }
  }
}

// The chain: one CTA per column tile [n, TILE] runs all T steps.  RG row
// groups of 8 rows (8*RG >= n) by CL = 256/RG column lanes of 8 columns
// (a quarter warp reads one W granule pair, broadcast, and 8 consecutive
// state granules, so neither read has a bank conflict):
// one step's N x TILE sums are the 256 threads' 8 x 8 blocks, all in
// registers, so the state tile sits in shared memory ONCE and is
// overwritten in place behind one barrier when every thread has read it.
// W_t^T streams through a 3-stage ring of kStageK k values filled by
// cp.async two stages ahead, one barrier per stage.
template <typename StateT, int RG>
__global__ void __launch_bounds__(kThreads, 2)
    fma_chain_kernel(const StateT* __restrict__ x, StateT* __restrict__ out,
                     const float* __restrict__ wt, int n, long long d,
                     int t_steps, int vec) {
  constexpr int CL = kThreads / RG;
  constexpr int kRows = kBlock * RG;  // = wt's ldw
  constexpr int kTile = kBlock * CL;
  constexpr int kStageK = stage_k(kRows);
  constexpr int kSlot = kStageK * kRows;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                    // [kStages][kStageK][kRows]
  float* st = ring + kStages * kSlot;    // [n][kTile]
  const int l = threadIdx.x % CL, g = threadIdx.x / CL;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTile;
  const int kchunks = (n + kStageK - 1) / kStageK;
  // a thread whose 8 rows all lie past n sums nothing (whole warps where
  // the tile is 256 columns or wider)
  const bool idle = 8 * g >= n;
  const long long q_total = static_cast<long long>(t_steps) * kchunks;

  long long fq = 0;  // the next stage to fetch: step fq / kchunks
  auto fetch = [&]() {
    if (fq < q_total) {
      const int c = static_cast<int>(fq % kchunks);
      const int k0 = c * kStageK;
      const int granules = min(kStageK, n - k0) * kRows / 4;
      const float* src =
          wt + (static_cast<size_t>(fq / kchunks) * n + k0) * kRows;
      float* dst = ring + static_cast<int>(fq % kStages) * kSlot;
      for (int q = threadIdx.x; q < granules; q += kThreads) {
        cp_async16(dst + 4 * q, src + 4 * q);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
    ++fq;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch();
  for (int e = threadIdx.x; e < n * kTile; e += kThreads) {
    const long long col = col0 + e % kTile;
    st[e] = col < d ? Dtype<StateT>::load(x + (e / kTile) * d + col) : 0.0f;
  }

  float acc[kBlock][kBlock];
#pragma unroll
  for (int r = 0; r < kBlock; ++r) {
#pragma unroll
    for (int c = 0; c < kBlock; ++c) acc[r][c] = 0.0f;
  }
  int t = 0, c = 0;
  for (long long q = 0; q < q_total; ++q) {
    cp_async_wait<kStages - 2>();  // this thread's part of stage q
    // all of stage q landed; the slot of stage q-1 is free; the state
    // (loaded, or written back by the last step) is visible
    __syncthreads();
    fetch();  // stage q+2, into the slot of stage q-1
    const int k0 = c * kStageK;
    const int klen = min(kStageK, n - k0);
    const float* w = ring + static_cast<int>(q % kStages) * kSlot + 8 * g;
    const float* xs = st + static_cast<size_t>(k0) * kTile + 4 * l;
    if (idle) {
    } else if (klen == kStageK) {
#pragma unroll
      for (int kk = 0; kk < kStageK; ++kk) {
        fma_k<kTile / 2>(acc, w + kk * kRows, xs + kk * kTile);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < klen; ++kk) {
        fma_k<kTile / 2>(acc, w + kk * kRows, xs + kk * kTile);
      }
    }
    if (++c < kchunks) continue;
    c = 0;
    if (++t == t_steps) {
      store_block<StateT, kTile / 2>(out, acc, n, d, 0, col0, g, l, vec);
      break;
    }
    __syncthreads();  // every thread has read the whole state: overwrite
#pragma unroll
    for (int r = 0; r < kBlock; ++r) {
      const int i = 8 * g + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = make_float4(Dtype<StateT>::round(acc[r][4 * h]),
                                     Dtype<StateT>::round(acc[r][4 * h + 1]),
                                     Dtype<StateT>::round(acc[r][4 * h + 2]),
                                     Dtype<StateT>::round(acc[r][4 * h + 3]));
        // rows past n are never stored (their W rows are zero, but a zero
        // times an inf is NaN) and never read
        if (i < n) {
          *reinterpret_cast<float4*>(st + static_cast<size_t>(i) * kTile +
                                     h * (kTile / 2) + 4 * l) = v;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][4 * h + j] = 0.0f;
      }
    }
  }
  cp_async_wait<0>();
}

// One step of the large-N path: dst = state(W_t @ src) for a [128 x 128]
// output tile per CTA, 16 x 16 threads of 8 x 8 blocks; W_t^T (the
// transposed copy, [k][ldw]) and src both stream through shared memory in
// stages of kStepK k values, loaded into registers one stage ahead and
// stored behind the current stage's products (one barrier per stage).  k
// runs 0 .. n-1 in order, so every element is the chain's sum bitwise.
template <typename StateT>
__global__ void __launch_bounds__(kThreads, 2)
    fma_step_kernel(const StateT* __restrict__ src, StateT* __restrict__ dst,
                    const float* __restrict__ wt, int n, int ldw,
                    long long d, int vec) {
  constexpr int CL = 16;
  __shared__ __align__(16) float ws[2][kStepK][kStepRows];
  __shared__ __align__(16) float xs[2][kStepK][kStepCols];
  const int l = threadIdx.x % CL, g = threadIdx.x / CL;
  // column tiles fastest (blockIdx.x): a W_t^T row tile stays in L2 for
  // the CTAs in flight (row tiles fastest measured 1.2-1.3x slower)
  const int row0 = blockIdx.y * kStepRows;
  const long long col0 = static_cast<long long>(blockIdx.x) * kStepCols;
  const int kchunks = (n + kStepK - 1) / kStepK;
  // this thread's loads: float4s of W^T (k = tid/32 + 8j, rows
  // 4*(tid%32)), and state values (column tid%128, k = tid/128 + 2j)
  constexpr int kWLoads = kStepK * kStepRows / 4 / kThreads;
  constexpr int kXLoads = kStepK * kStepCols / kThreads;
  const int wk = threadIdx.x / 32, wr = 4 * (threadIdx.x % 32);
  const int xc = threadIdx.x % kStepCols, xk = threadIdx.x / kStepCols;
  const long long col = col0 + xc;
  const bool idle = row0 + 8 * g >= n;
  float4 wreg[kWLoads];
  float xreg[kXLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int k = k0 + wk + 8 * j;
      wreg[j] = k < n ? *reinterpret_cast<const float4*>(
                            wt + static_cast<size_t>(k) * ldw + row0 + wr)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int k = k0 + xk + 2 * j;
      xreg[j] = k < n && col < d ? Dtype<StateT>::load(src + k * d + col)
                                 : 0.0f;
    }
  };
  auto stash = [&](int b) {
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      *reinterpret_cast<float4*>(&ws[b][wk + 8 * j][wr]) = wreg[j];
    }
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) xs[b][xk + 2 * j][xc] = xreg[j];
  };
  float acc[kBlock][kBlock];
#pragma unroll
  for (int r = 0; r < kBlock; ++r) {
#pragma unroll
    for (int c = 0; c < kBlock; ++c) acc[r][c] = 0.0f;
  }
  load(0);
  stash(0);
  __syncthreads();
  for (int c = 0; c < kchunks; ++c) {
    const bool more = c + 1 < kchunks;
    if (more) load((c + 1) * kStepK);
    const int klen = min(kStepK, n - c * kStepK);
    const int b = c & 1;
    if (!idle) {
#pragma unroll 4
      for (int kk = 0; kk < klen; ++kk) {
        fma_k<kStepCols / 2>(acc, &ws[b][kk][8 * g], &xs[b][kk][4 * l]);
      }
    }
    // the other buffer was last read in stage c-1, before the last barrier
    if (more) stash(b ^ 1);
    __syncthreads();
  }
  store_block<StateT, kStepCols / 2>(dst, acc, n, d, row0, col0, g, l, vec);
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

constexpr int kWarpsM = 4;  // warps along the rows; 2 along the columns

// m16 tiles per warp: a pass of 16*kWarpsM*MT rows, MT = 1, 2 or 4
__host__ __device__ inline int m_tiles(int n) {
  const int m = (pad16(n) + 63) / 64;
  return m <= 1 ? 1 : (m == 2 ? 2 : 4);
}

// A warp holds NT = 2, 4 or 8 n8 tiles of columns, so a tile is 2 warps x
// 8 x NT columns: 32, 64 or 128.  Returns NT, or 0 for a tile not taken.
__host__ __device__ inline int n_tiles(int tile) {
  constexpr int per_nt = kWarps / kWarpsM * 8;
  const int nt = tile / per_nt;
  return tile % per_nt == 0 && (nt == 2 || nt == 4 || nt == 8) ? nt : 0;
}

__host__ __device__ inline size_t smem_bytes(int n, int tile, bool split) {
  const size_t ring = static_cast<size_t>(kStages) * 16 * kWarpsM *
                      m_tiles(n) * kStageK;
  return sizeof(bf16) * ((split ? 2 : 1) * ring +
                         2 * static_cast<size_t>(pad16(n)) * tile);
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
template <int MT, int NT, bool SPLIT>
__global__ void __launch_bounds__(kThreads, MT == 4 ? 1 : (MT == 2 ? 2 : 3))
    tc_gossip_kernel(const void* __restrict__ x, void* __restrict__ out,
                     const bf16* __restrict__ stack, int n, long long d,
                     int t_steps, int state_bf16) {
  constexpr int WM = kWarpsM;
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

template <int MT, int NT, bool SPLIT>
cudaError_t launch(const void* x, void* out, const void* stack, int n,
                   long long d, int t_steps, int state_bf16,
                   cudaStream_t stream) {
  auto kernel = tc_gossip_kernel<MT, NT, SPLIT>;
  constexpr int tile = kWarps / kWarpsM * 8 * NT;
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

template <int MT, bool SPLIT>
cudaError_t dispatch_nt(int tile, const void* x, void* out,
                        const void* stack, int n, long long d, int t_steps,
                        int state_bf16, cudaStream_t s) {
  switch (n_tiles(tile)) {
    case 2:
      return launch<MT, 2, SPLIT>(x, out, stack, n, d, t_steps, state_bf16,
                                  s);
    case 4:
      return launch<MT, 4, SPLIT>(x, out, stack, n, d, t_steps, state_bf16,
                                  s);
    default:
      return launch<MT, 8, SPLIT>(x, out, stack, n, d, t_steps, state_bf16,
                                  s);
  }
}

template <bool SPLIT>
cudaError_t dispatch(int tile, const void* x, void* out, const void* stack,
                     int n, long long d, int t_steps, int state_bf16,
                     cudaStream_t s) {
  switch (m_tiles(n)) {
    case 1:
      return dispatch_nt<1, SPLIT>(tile, x, out, stack, n, d, t_steps,
                                   state_bf16, s);
    case 2:
      return dispatch_nt<2, SPLIT>(tile, x, out, stack, n, d, t_steps,
                                   state_bf16, s);
    default:
      return dispatch_nt<4, SPLIT>(tile, x, out, stack, n, d, t_steps,
                                   state_bf16, s);
  }
}

// One step of the large-N path on the tensor cores: dst = state(W_t @
// src) for a [128 rows x 64 columns] output tile per CTA.  8 warps, 4 along
// the rows (two m16 tiles each) and 2 along the columns (four n8 tiles
// each).  W_t (the zero-padded bf16 stack) and src, rounded to bf16, both
// stream through shared memory in chunks of 32 k, loaded into registers one
// chunk ahead and stored behind the current chunk's products, in the
// shared-memory mainloop's swizzled layouts (w_idx, state_idx).  Each
// output element runs the mainloop's mma sequence: acc from 0, the k16
// steps in order, k < npad; so this path equals tc_gossip_kernel bitwise.
constexpr int kStepRows = 128, kStepCols = 64;

template <typename StateT>
__global__ void __launch_bounds__(kThreads, 2)
    tc_step_kernel(const StateT* __restrict__ src, StateT* __restrict__ dst,
                   const bf16* __restrict__ w, int n, long long d) {
  constexpr int MT = 2, NT = 4;
  __shared__ __align__(128) bf16 ws[2][kStepRows * kStageK];
  __shared__ __align__(128) bf16 xs[2][kStageK * kStepCols];
  const int npad = pad16(n);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  // row tiles fastest: the CTAs in flight share their columns of the
  // state, read from device memory once (measured 1.12x faster than column
  // tiles fastest at N = 4095, where the bf16 stack fits L2)
  const int row_tiles = (npad + kStepRows - 1) / kStepRows;
  const int row0 = static_cast<int>(blockIdx.x % row_tiles) * kStepRows;
  const long long col0 =
      static_cast<long long>(blockIdx.x / row_tiles) * kStepCols;
  const int kchunks = (npad + kStageK - 1) / kStageK;
  // loads: two 16-byte granules of W (row gi/4, granule gi%4), and eight
  // state values (column tid%64, k = tid/64 + 4j)
  uint4 wreg[2];
  float xreg[8];
  const int xc = threadIdx.x % kStepCols, xk = threadIdx.x / kStepCols;
  const long long col = col0 + xc;
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gi = threadIdx.x + j * kThreads;
      const int r = row0 + gi / 4, k = k0 + (gi % 4) * 8;
      wreg[j] = r < npad && k < npad
                    ? *reinterpret_cast<const uint4*>(
                          w + static_cast<size_t>(r) * npad + k)
                    : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + xk + 4 * j;
      xreg[j] = k < n && col < d ? Dtype<StateT>::load(src + k * d + col)
                                 : 0.0f;
    }
  };
  auto stash = [&](int b) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gi = threadIdx.x + j * kThreads;
      *reinterpret_cast<uint4*>(ws[b] + w_idx(gi / 4, gi % 4)) = wreg[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xs[b][state_idx<kStepCols>(xk + 4 * j, xc)] =
          __float2bfloat16_rn(xreg[j]);
    }
  };
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;
    }
  }
  const int a_row = lane & 15, a_gran = lane >> 4;
  const int a_swz = (a_row >> 1) & 3;
  const int b_k = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_col = wn * NT * 8 + (lane >> 4) * 8;
  const int m_row0 = wm * MT * 16;
  load(0);
  stash(0);
  __syncthreads();
  for (int c = 0; c < kchunks; ++c) {
    const bool more = c + 1 < kchunks;
    if (more) load((c + 1) * kStageK);
    const bf16* wb = ws[c & 1];
    const bf16* xb = xs[c & 1];
#pragma unroll
    for (int s = 0; s < kStageK / kK; ++s) {
      if (c * kStageK + s * kK >= npad) break;
      uint32_t b[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        ldsm_x4_trans(b[j], xb + state_idx<kStepCols>(s * kK + b_k,
                                                      b_col + j * 16));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldsm_x4(a, wb + (m_row0 + i * 16 + a_row) * kStageK +
                       (((2 * s + a_gran) ^ a_swz) << 3));
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          mma(acc[i][2 * j], a, b[j][0], b[j][1]);
          mma(acc[i][2 * j + 1], a, b[j][2], b[j][3]);
        }
      }
    }
    // the other buffers were last read in chunk c-1, before the barrier
    if (more) stash((c & 1) ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const long long gc = col0 + wn * NT * 8 + j * 8 + 2 * (lane & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + m_row0 + i * 16 + (lane >> 2) + 8 * hh;
        if (r >= n) continue;
        if (gc < d) Dtype<StateT>::store(dst + r * d + gc, acc[i][j][2 * hh]);
        if (gc + 1 < d) {
          Dtype<StateT>::store(dst + r * d + gc + 1, acc[i][j][2 * hh + 1]);
        }
      }
    }
  }
}

}  // namespace tc

// ----------------------------------------- register paths (N <= 16)

// Both register paths stage W in shared memory up to kStageBytes at a
// time: the whole stack when it fits (loaded once per CTA), else windows
// of `window` steps, loaded behind a CTA barrier for every column group.
constexpr int kStageBytes = 64 * 1024;
constexpr int kRegThreads = 256;
constexpr int kRegMaxCtasPerSm = 8;

// BYTES (4 or 8) from global `src` to shared `dst`, or zeros where `valid`
// is false (src-size 0: nothing is read)
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}

namespace fregs {  // f32 stack: FP32 FMA, the columns' rows in registers

constexpr int kMaxRows = 16;  // N_REG_F32
constexpr int kCtaCols = 2 * kRegThreads;  // a thread holds a column pair

__host__ __device__ inline size_t step_bytes(int rows) {
  return sizeof(float) * static_cast<size_t>(rows) * rows;
}

// A thread owns a column pair of all NR rows (rows past n are never read
// or stored): the pair of lane l of warp w sits at column 64w + 2l of the
// CTA's kCtaCols, so a warp's access to a row is 256 contiguous bytes
// (f32).  The CTA walks its column groups blockIdx.x, blockIdx.x +
// gridDim.x, ...  W_t sits in shared memory transposed, wsm[t][k][i] =
// W_t[i, k], so the NR coefficients of one k are NR/4 broadcast LDS.128
// feeding 2*NR FMAs.  Each sum is the unbroken chain acc = fma(W[i,k],
// x[k], acc), acc = +0, k = 0 .. n-1 in order: the shared-memory FMA
// path's order, so the two paths give the same bits.
template <typename StateT, int NR>
__global__ void __launch_bounds__(kRegThreads, 2)
    fma_regs_gossip_kernel(const StateT* __restrict__ x,
                           StateT* __restrict__ out,
                           const float* __restrict__ stack, int n,
                           long long d, int t_steps, int window, int vec) {
  static_assert(NR % 4 == 0, "W columns are read as float4");
  extern __shared__ __align__(16) float wsm[];  // [window][NR k][NR i]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long groups = (d + kCtaCols - 1) / kCtaCols;
  const bool resident = window >= t_steps;
  auto stage = [&](int t0, int len) {
    // i fastest: the shared-memory stores are conflict-free
    for (int e = threadIdx.x; e < len * NR * NR; e += kRegThreads) {
      const int s = e / (NR * NR), k = (e / NR) % NR, i = e % NR;
      wsm[e] = i < n && k < n
                   ? stack[(static_cast<size_t>(t0 + s) * n + i) * n + k]
                   : 0.0f;
    }
  };
  if (resident) {
    stage(0, t_steps);
    __syncthreads();
  }
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long col = g * kCtaCols + 64 * warp + 2 * lane;
    float xs[NR][2];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float2 v = i < n ? load_pair(x, i, d, col, vec)
                             : make_float2(0.0f, 0.0f);
      xs[i][0] = v.x;
      xs[i][1] = v.y;
    }
    for (int t0 = 0; t0 < t_steps; t0 += window) {
      const int len = min(window, t_steps - t0);
      if (!resident) {
        __syncthreads();  // every thread is done with the last window
        stage(t0, len);
        __syncthreads();
      }
      for (int s = 0; s < len; ++s) {
        const float* w = wsm + s * NR * NR;
        float acc[NR][2];
#pragma unroll
        for (int i = 0; i < NR; ++i) acc[i][0] = acc[i][1] = 0.0f;
#pragma unroll
        for (int k = 0; k < NR; ++k) {
          if (k >= n) break;
          float wv[NR];
#pragma unroll
          for (int q = 0; q < NR / 4; ++q) {
            const float4 v =
                *reinterpret_cast<const float4*>(w + k * NR + 4 * q);
            wv[4 * q] = v.x;
            wv[4 * q + 1] = v.y;
            wv[4 * q + 2] = v.z;
            wv[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float v = xs[k][c];
#pragma unroll
            for (int i = 0; i < NR; ++i) {
              acc[i][c] = __fmaf_rn(wv[i], v, acc[i][c]);
            }
          }
        }
        // rows past n hold garbage from here on; no k >= n is ever read
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          xs[i][0] = Dtype<StateT>::round(acc[i][0]);
          xs[i][1] = Dtype<StateT>::round(acc[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      if (i >= n) break;
      store_pair(out, i, d, col, vec, xs[i][0], xs[i][1]);
    }
  }
}

}  // namespace fregs

namespace tcregs {  // bf16 stack, N <= 16: tensor cores, chained in registers

using bf16 = __nv_bfloat16;

constexpr int kMaxRows = 16;               // N_REG_TC: one k16 / two n8
constexpr int kWarps = kRegThreads / 32;
constexpr int kCT = 2;                     // m16 column tiles per warp
constexpr int kWarpCols = 16 * kCT;        // a warp's item
constexpr int kCtaCols = kWarps * kWarpCols;
constexpr int kStride = kWarpCols + 4;     // f32 per staging row: 144 B
constexpr int kStageFloats = 16 * kStride;  // one staging buffer
constexpr int kStepWords = 128;            // W_t's 16x16 bf16 as 32-bit
constexpr int kPairs = kWarpCols / 2;      // column pairs of a row
constexpr int kRowsPerPass = 32 / kPairs;  // rows a warp moves at once
static_assert(32 % kPairs == 0, "a row's pairs fill whole lanes");

__host__ __device__ inline size_t step_bytes() { return 4 * kStepWords; }

// the staged stack, then two staging buffers per warp
__host__ __device__ inline size_t smem_bytes(int window) {
  return step_bytes() * window + sizeof(float) * 2 * kWarps * kStageFloats;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One item's [16 workers][kWarpCols] of the state into a staging buffer
// as it lies in device memory (f32 rows of kStride floats, bf16 rows of
// 2*kStride values): pairs by cp.async where `vec`, else scalars loaded
// and stored by the lanes; rows past n and columns past d are zero.
template <typename StateT>
__device__ __forceinline__ void stage_in(const StateT* __restrict__ x,
                                         StateT* buf, int n, long long d,
                                         long long c0, bool valid, int vec,
                                         int lane) {
  constexpr int kRow = sizeof(float) * kStride / sizeof(StateT);
  const int prow = lane / kPairs, pcol = 2 * (lane % kPairs);
  const long long col = c0 + pcol;
#pragma unroll
  for (int it = 0; it < 16 / kRowsPerPass; ++it) {
    const int r = it * kRowsPerPass + prow;
    StateT* dst = buf + r * kRow + pcol;
    const bool in = valid && r < n;
    if (vec) {
      cp_async_zfill<2 * sizeof(StateT)>(dst, in && col < d ? x + r * d + col
                                                            : x,
                                         in && col < d);
    } else {
      const float2 v = in ? load_pair(x, r, d, col, 0)
                          : make_float2(0.0f, 0.0f);
      dst[0] = static_cast<StateT>(v.x);
      dst[1] = static_cast<StateT>(v.y);
    }
  }
}

// The A fragments of the staged item, rounded to bf16 (the stack dtype):
// ldmatrix.trans of a bf16 buffer (matrix mq = lane/8 at k = 8*(mq/2) +
// lane%8, m = 8*(mq%2)), or the same elements read from an f32 buffer and
// packed.
__device__ __forceinline__ void a_fragments(const bf16* buf,
                                            uint32_t (&a)[kCT][4], int lane) {
  const int mrow = lane % 8, mq = lane / 8;
#pragma unroll
  for (int c = 0; c < kCT; ++c) {
    tc::ldsm_x4_trans(a[c], buf + ((mq >> 1) * 8 + mrow) * 2 * kStride +
                                16 * c + (mq & 1) * 8);
  }
}

__device__ __forceinline__ void a_fragments(const float* buf,
                                            uint32_t (&a)[kCT][4], int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int c = 0; c < kCT; ++c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 2 * t + 8 * (q >> 1), m = 16 * c + g + 8 * (q & 1);
      a[c][q] = pack_bf16(buf[k * kStride + m], buf[(k + 1) * kStride + m]);
    }
  }
}

// The transposed product x^T <- x^T W_t^T, one mma.m16n8k16 per n8 tile:
// A (m16 x k16) is x^T, m = 16 columns of the state, k = the workers; B
// (k16 x n8) is W_t^T, two n8 tiles of workers.  With g = lane/4 and
// t = lane%4, the accumulator of n8 tile j holds (m = g, n = 8j+2t, +1)
// and (m = g+8, same n), and the A fragment wants (m = g, k = 2t, +1),
// (m = g+8, k = 2t, +1), (m = g, k = 2t+8, +1), (m = g+8, k = 2t+8, +1):
// the two tiles' accumulators, rounded to bf16 pairs, ARE the next step's
// A fragment, with no shuffle (FlashAttention's P.V reuse).  A warp thus
// carries kCT m16 tiles of columns through all T steps in registers, with
// no barrier.  B's fragment (k = 2t, +1; n = g) is two consecutive bf16 of
// row g of W_t, so the stack is staged permuted: for every step, lane l's
// four words {b0, b1 of tile 0, b0, b1 of tile 1} lie at words 4l..4l+3,
// one conflict-free LDS.128.
//
// Work and pipeline.  An item is one warp's kWarpCols columns; warp w of
// CTA b takes items b + gridDim.x*w, then every 8*gridDim.x further, so a
// last, partial round is spread over all SMs.  The state enters through
// one of two staging buffers per warp, filled by cp.async as it lies in
// device memory (rows of D = 273,258 are 8- (f32) or 4-byte (bf16)
// aligned, not 16, so pairs), one item ahead: the next item's loads are in
// flight while this one is multiplied and stored.  The last step's f32
// sums go back through the buffer just read, so device memory sees whole
// rows of the warp's columns.  Workers past n (the stack is zero-padded
// to 16) are zeroed every step, so a NaN or an inf in the state cannot
// reach a real row through a 0 * inf.
template <typename StateT>
__global__ void __launch_bounds__(kRegThreads)
    tc_regs_gossip_kernel(const StateT* __restrict__ x,
                          StateT* __restrict__ out,
                          const uint32_t* __restrict__ stack, int n,
                          long long d, int t_steps, int window, int vec) {
  extern __shared__ __align__(16) uint4 smem_tc[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  uint4* frag = smem_tc;  // [window][32 lanes]
  float* bufs = reinterpret_cast<float*>(frag + window * 32) +
                warp * 2 * kStageFloats;
  const long long items = (d + kWarpCols - 1) / kWarpCols;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const long long first = static_cast<long long>(warp) * gridDim.x +
                          blockIdx.x;
  // rounds are uniform across the CTA (its barriers); warp 0 has the most
  const long long rounds = (items - blockIdx.x + stride - 1) / stride;
  const bool resident = window >= t_steps;
  auto fill = [&](int t0, int len) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(frag);
    for (int e = threadIdx.x; e < len * kStepWords; e += kRegThreads) {
      const int s = e / kStepWords, wi = e % kStepWords;
      const int r = wi / 8, w = wi % 8;  // row r of W_t, k = 2w, 2w+1
      const int ln = (r % 8) * 4 + (w % 4), slot = (r / 8) * 2 + w / 4;
      dst[s * kStepWords + ln * 4 + slot] =
          stack[static_cast<size_t>(t0 + s) * kStepWords + wi];
    }
  };
  auto buf_of = [&](long long r) {
    return reinterpret_cast<StateT*>(bufs + (r & 1) * kStageFloats);
  };
  auto load = [&](long long r) {
    const long long it = first + r * stride;
    if (r < rounds) {
      stage_in(x, buf_of(r), n, d, it * kWarpCols, it < items, vec, lane);
    }
    cp_async_commit();  // one group per round, empty past the end
  };
  load(0);
  load(1);
  if (resident) {  // behind the first items' loads
    fill(0, t_steps);
    __syncthreads();
  }
  const int gq = lane / 4, tq = lane % 4;
  const int prow = lane / kPairs, pcol = 2 * (lane % kPairs);
  for (long long r = 0; r < rounds; ++r) {
    const long long it = first + r * stride;
    const long long c0 = it * kWarpCols;
    float* buf = reinterpret_cast<float*>(buf_of(r));
    cp_async_wait<1>();  // this round's item has landed
    __syncwarp();
    uint32_t a[kCT][4];
    a_fragments(buf_of(r), a, lane);
    float acc[kCT][2][4];
    for (int t0 = 0; t0 < t_steps; t0 += window) {
      const int len = min(window, t_steps - t0);
      if (!resident) {
        __syncthreads();
        fill(t0, len);
        __syncthreads();
      }
      for (int s = 0; s < len; ++s) {
        const uint4 b = frag[s * 32 + lane];
#pragma unroll
        for (int c = 0; c < kCT; ++c) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.0f;
          }
          tc::mma(acc[c][0], a[c], b.x, b.y);
          tc::mma(acc[c][1], a[c], b.z, b.w);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int w0 = 8 * j + 2 * tq;  // this lane's two workers
            if (w0 >= n) acc[c][j][0] = acc[c][j][2] = 0.0f;
            if (w0 + 1 >= n) acc[c][j][1] = acc[c][j][3] = 0.0f;
          }
          a[c][0] = pack_bf16(acc[c][0][0], acc[c][0][1]);
          a[c][1] = pack_bf16(acc[c][0][2], acc[c][0][3]);
          a[c][2] = pack_bf16(acc[c][1][0], acc[c][1][1]);
          a[c][3] = pack_bf16(acc[c][1][2], acc[c][1][3]);
        }
      }
    }
    // the last step's f32 sums, [worker][column], then whole rows out
    __syncwarp();  // every lane has read its fragments from the buffer
#pragma unroll
    for (int c = 0; c < kCT; ++c) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int w0 = 8 * j + 2 * tq, m = 16 * c + gq;
        buf[w0 * kStride + m] = acc[c][j][0];
        buf[(w0 + 1) * kStride + m] = acc[c][j][1];
        buf[w0 * kStride + m + 8] = acc[c][j][2];
        buf[(w0 + 1) * kStride + m + 8] = acc[c][j][3];
      }
    }
    __syncwarp();
    if (it < items) {
#pragma unroll
      for (int i = 0; i < 16 / kRowsPerPass; ++i) {
        const int row = i * kRowsPerPass + prow;
        if (row < n) {
          const float2 o =
              *reinterpret_cast<const float2*>(buf + row * kStride + pcol);
          store_pair(out, row, d, c0 + pcol, vec, o.x, o.y);
        }
      }
    }
    __syncwarp();  // the buffer is read before the item two ahead lands
    load(r + 2);
  }
  cp_async_wait<0>();
}

}  // namespace tcregs

// A register path's grid: CTAs of one configuration resident on the whole
// card at once (at most kRegMaxCtasPerSm per SM), from the occupancy API,
// kept per kernel, device and shared memory.  The kernel's shared-memory
// attribute is only ever raised, so every kept configuration stays
// launchable.
struct Grid {
  const void* kernel;
  int device;
  size_t smem;
  long long ctas;
};

std::mutex grid_mutex;
std::vector<Grid> grids;

long long card_ctas(const void* kernel, size_t smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  std::lock_guard<std::mutex> lock(grid_mutex);
  size_t allowed = 48 * 1024;  // needs no attribute
  for (const Grid& g : grids) {
    if (g.kernel != kernel || g.device != device) continue;
    if (g.smem == smem) return g.ctas;
    allowed = g.smem > allowed ? g.smem : allowed;
  }
  int blocks = 0, sms = 0;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kRegThreads, smem);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const long long ctas =
      static_cast<long long>(sms) *
      (blocks < kRegMaxCtasPerSm ? blocks : kRegMaxCtasPerSm);
  grids.push_back({kernel, device, smem, ctas});
  return ctas;
}

// Launch a register-path kernel on min(work items, the card's fill) CTAs.
cudaError_t launch_regs(const void* kernel, long long items, size_t smem,
                        void** args, cudaStream_t stream) {
  const long long fill = card_ctas(kernel, smem);
  if (fill < 0) return static_cast<cudaError_t>(-fill);
  if (fill == 0) return cudaErrorInvalidConfiguration;
  const unsigned blocks = static_cast<unsigned>(items < fill ? items : fill);
  cudaError_t err = cudaLaunchKernel(kernel, dim3(blocks), dim3(kRegThreads),
                                     args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// A kernel as the runtime's launch API takes it.
template <typename Kernel>
const void* entry(Kernel* kernel) {
  return (const void*)kernel;
}

template <typename StateT>
const void* pick_fma_regs(int rows) {
  return rows == 8 ? entry(fregs::fma_regs_gossip_kernel<StateT, 8>)
                   : entry(fregs::fma_regs_gossip_kernel<StateT, 16>);
}

// Paths: 0 = FMA chain (f32 stack, 16 < n <= 256, one state tile in
// shared memory), 1 = tensor cores unsplit, 2 = tensor cores split, 3 =
// FMA with the columns in registers (f32 stack, n <= 16), 4 = tensor cores
// chained in registers (bf16 stack, n <= 16), 5 = FMA one launch per step
// (f32 stack, large n), 6 = tensor cores one launch per step (bf16 stack,
// large n).
enum Path {
  kFma = 0, kTc = 1, kSplit = 2, kFmaRegs = 3, kTcRegs = 4, kFmaStep = 5,
  kTcStep = 6
};

// Whether a shared-memory `path` (0-2) takes `tile` columns at n.
bool path_takes_tile(int n, int tile, int path) {
  return path == kFma ? fp32::chain_takes(n, tile) : tc::n_tiles(tile) != 0;
}

size_t path_smem_bytes(int n, int tile, int path) {
  return path == kFma ? fp32::chain_smem_bytes(n, tile)
                      : tc::smem_bytes(n, tile, path == kSplit);
}

// Whether a register path takes this launch shape.
bool regs_take(int n, int path, int tile, int rows, int window) {
  if (window < 1) return false;
  if (path == kFmaRegs) {
    return (rows == 8 || rows == fregs::kMaxRows) && n <= rows &&
           tile == fregs::kCtaCols &&
           fregs::step_bytes(rows) * window <= kStageBytes;
  }
  return n <= tcregs::kMaxRows && rows == tcregs::kMaxRows &&
         tile == tcregs::kCtaCols &&
         tcregs::step_bytes() * window <= kStageBytes;
}

size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

// Scratch in device memory: the f32 stack transposed ([t][k][ldw], paths
// 0 and 5), then, on the per-step paths, the states between steps (two
// where t >= 3, one where t == 2).
size_t wt_bytes(int n, int t_steps, int ldw) {
  return align256(sizeof(float) * static_cast<size_t>(t_steps) * n * ldw);
}

size_t state_buffers(int t_steps) {
  return t_steps >= 3 ? 2 : (t_steps == 2 ? 1 : 0);
}

long long scratch_bytes(int n, long long d, int t_steps, int path, int tile,
                        int state_dtype) {
  const size_t state =
      align256((state_dtype == 0 ? 4 : 2) * static_cast<size_t>(n) * d);
  switch (path) {
    case kFma:
      return static_cast<long long>(
          wt_bytes(n, t_steps, fp32::chain_rows(tile)));
    case kFmaStep:
      return static_cast<long long>(wt_bytes(n, t_steps, fp32::step_ldw(n)) +
                                    state_buffers(t_steps) * state);
    case kTcStep:
      return static_cast<long long>(state_buffers(t_steps) * state);
    default:
      return 0;
  }
}

cudaError_t transpose(const float* stack, float* wt, int n, int ldw,
                      int t_steps, cudaStream_t s) {
  const dim3 grid((ldw + 31) / 32, (n + 31) / 32,
                  t_steps < 65535 ? t_steps : 65535);
  fp32::transpose_stack<<<grid, dim3(32, 8), 0, s>>>(stack, wt, n, ldw,
                                                     t_steps);
  return cudaGetLastError();
}

template <typename StateT, int RG>
cudaError_t launch_chain(const void* x, void* out, const float* wt, int n,
                         long long d, int t_steps, int vec, cudaStream_t s) {
  auto kernel = fp32::fma_chain_kernel<StateT, RG>;
  constexpr int tile = fp32::kBlock * fp32::kThreads / RG;
  const size_t smem = fp32::chain_smem_bytes(n, tile);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((d + tile - 1) / tile);
  kernel<<<blocks, fp32::kThreads, smem, s>>>(
      static_cast<const StateT*>(x), static_cast<StateT*>(out), wt, n, d,
      t_steps, vec);
  return cudaGetLastError();
}

template <typename StateT>
cudaError_t chain(int tile, const void* x, void* out, const float* wt, int n,
                  long long d, int t_steps, int vec, cudaStream_t s) {
  switch (tile) {
    case 512:
      return launch_chain<StateT, 4>(x, out, wt, n, d, t_steps, vec, s);
    case 256:
      return launch_chain<StateT, 8>(x, out, wt, n, d, t_steps, vec, s);
    case 128:
      return launch_chain<StateT, 16>(x, out, wt, n, d, t_steps, vec, s);
    default:
      return launch_chain<StateT, 32>(x, out, wt, n, d, t_steps, vec, s);
  }
}

// The per-step paths: step t reads x (t = 0) or the buffer step t-1
// wrote, and writes out (the last step) or buffer t % 2.
template <typename StateT>
cudaError_t steps(int path, const void* x, void* out, const void* stack,
                  unsigned char* scratch, int n, long long d, int t_steps,
                  int vec, cudaStream_t s) {
  const StateT* src = static_cast<const StateT*>(x);
  StateT* bufs[2];
  const float* wt = reinterpret_cast<const float*>(scratch);
  const int ldw = fp32::step_ldw(n);
  size_t at = path == kFmaStep ? wt_bytes(n, t_steps, ldw) : 0;
  const size_t state = align256(sizeof(StateT) * static_cast<size_t>(n) * d);
  for (int b = 0; b < 2; ++b) bufs[b] =
      reinterpret_cast<StateT*>(scratch + at + b * state);
  if (path == kFmaStep) {
    cudaError_t err = transpose(static_cast<const float*>(stack),
                                reinterpret_cast<float*>(scratch), n, ldw,
                                t_steps, s);
    if (err != cudaSuccess) return err;
  }
  for (int t = 0; t < t_steps; ++t) {
    StateT* dst = t + 1 == t_steps ? static_cast<StateT*>(out) : bufs[t % 2];
    if (path == kFmaStep) {
      const dim3 grid(static_cast<unsigned>((d + fp32::kStepCols - 1) /
                                            fp32::kStepCols),
                      (n + fp32::kStepRows - 1) / fp32::kStepRows);
      fp32::fma_step_kernel<StateT><<<grid, fp32::kThreads, 0, s>>>(
          src, dst, wt + static_cast<size_t>(t) * n * ldw, n, ldw, d, vec);
    } else {
      const int npad = tc::pad16(n);
      const unsigned grid = static_cast<unsigned>(
          (d + tc::kStepCols - 1) / tc::kStepCols *
          ((npad + tc::kStepRows - 1) / tc::kStepRows));
      tc::tc_step_kernel<StateT><<<grid, tc::kThreads, 0, s>>>(
          src, dst,
          static_cast<const tc::bf16*>(stack) +
              static_cast<size_t>(t) * npad * npad,
          n, d);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared memory one CTA of a shared-memory `path` (0, 1 or 2) needs at
// `tile` columns, in bytes, or -1 if `path` does not take that tile at n.
// Tiles: 64, 128, 256 and 512 on path 0 (n <= 16384 / tile); 32, 64 and 128 on
// paths 1 and 2 (the wrapper picks the tile).
long long fused_gossip_smem_bytes(int n, int tile, int path) {
  if (n < 1 || path < kFma || path > kSplit ||
      !path_takes_tile(n, tile, path)) {
    return -1;
  }
  return static_cast<long long>(path_smem_bytes(n, tile, path));
}

long long fused_gossip_smem_limit() { return kMaxSharedBytes; }

// The largest n a register path (3 or 4) takes, else -1.
long long fused_gossip_reg_max_n(int path) {
  return path == kFmaRegs ? fregs::kMaxRows
                          : (path == kTcRegs ? tcregs::kMaxRows : -1);
}

// Shared memory the register paths may give to the staged stack, in bytes.
long long fused_gossip_stage_bytes() { return kStageBytes; }

// Device memory a launch of `path` needs as `scratch`, in bytes (0 where
// it needs none): the transposed f32 stack (paths 0 and 5) and the states
// between steps (paths 5 and 6).
long long fused_gossip_scratch_bytes(int n, long long d, int t_steps,
                                     int path, int tile, int state_dtype) {
  if (n < 1 || d < 1 || t_steps < 1) return -1;
  return scratch_bytes(n, d, t_steps, path, tile, state_dtype);
}

// Run t_steps steps of x[n, d] <- stack[t] @ x into out[n, d] on `stream`
// along `path` (see Path).  An f32 stack (paths 0, 3, 5) is [t_steps, n,
// n]; a bf16 stack (paths 1, 2, 4, 6) is [t_steps, npad, npad], npad = n
// rounded up to a multiple of 16, zero-padded.  Path 0 takes `tile` = 64,
// 128, 256 or 512 columns per CTA with 16384 / tile >= n rows; paths 1-2 one
// CTA per `tile` columns (a tile fused_gossip_smem_bytes takes); rows and
// window are unused there.  The register paths take a persistent grid:
// `tile` columns per CTA and round (path 3: 512; path 4: 256), `rows` the
// rows a thread holds (path 3: 8 or 16, >= n; path 4: 16), and `window`
// the steps of the stack staged at a time (at most
// fused_gossip_stage_bytes).  Paths 5 and 6 launch one kernel per step
// (tile, rows and window unused).  `scratch` holds
// fused_gossip_scratch_bytes of device memory (paths 0, 5 and 6).
// state_dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launches (0 = cudaSuccess), or cudaErrorInvalidValue for
// arguments the kernels do not take.
int fused_gossip_launch(const void* x, void* out, const void* stack,
                        void* scratch, int n, long long d, int t_steps,
                        int path, int tile, int rows, int window,
                        int state_dtype, void* stream) {
  if (n < 1 || d < 1 || t_steps < 1 || path < kFma || path > kTcStep ||
      (state_dtype != 0 && state_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  // pairs move as one access where every row's pair is aligned: even d
  // and base pointers aligned to a pair
  const size_t pair = state_dtype == 0 ? 8 : 4;
  int vec = d % 2 == 0 && reinterpret_cast<uintptr_t>(x) % pair == 0 &&
            reinterpret_cast<uintptr_t>(out) % pair == 0;
  cudaError_t err;
  if (path == kFmaStep || path == kTcStep) {
    if (scratch == nullptr && t_steps >= 2) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // intermediate states are [n, d] buffers of scratch (aligned): pairs
    // there are aligned exactly where they are in x and out
    auto* buf = static_cast<unsigned char*>(scratch);
    err = state_dtype == 0
              ? steps<float>(path, x, out, stack, buf, n, d, t_steps, vec, s)
              : steps<__nv_bfloat16>(path, x, out, stack, buf, n, d, t_steps,
                                     vec, s);
    return static_cast<int>(err);
  }
  if (path == kFmaRegs || path == kTcRegs) {
    if (!regs_take(n, path, tile, rows, window)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    window = window < t_steps ? window : t_steps;
    void* args[] = {&x, &out, &stack, &n, &d, &t_steps, &window, &vec};
    const long long items = (d + tile - 1) / tile;
    if (path == kFmaRegs) {
      const void* kernel = state_dtype == 0
                               ? pick_fma_regs<float>(rows)
                               : pick_fma_regs<__nv_bfloat16>(rows);
      err = launch_regs(kernel, items, fregs::step_bytes(rows) * window,
                        args, s);
    } else {
      const void* kernel =
          state_dtype == 0
              ? entry(tcregs::tc_regs_gossip_kernel<float>)
              : entry(tcregs::tc_regs_gossip_kernel<__nv_bfloat16>);
      err = launch_regs(kernel, items, tcregs::smem_bytes(window), args, s);
    }
    return static_cast<int>(err);
  }
  if (!path_takes_tile(n, tile, path) ||
      path_smem_bytes(n, tile, path) > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path == kFma) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    float* wt = static_cast<float*>(scratch);
    err = transpose(static_cast<const float*>(stack), wt, n,
                    fp32::chain_rows(tile), t_steps, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = state_dtype == 0
              ? chain<float>(tile, x, out, wt, n, d, t_steps, vec, s)
              : chain<__nv_bfloat16>(tile, x, out, wt, n, d, t_steps, vec,
                                     s);
  } else if (path == kSplit) {
    err = tc::dispatch<true>(tile, x, out, stack, n, d, t_steps, state_dtype,
                             s);
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
