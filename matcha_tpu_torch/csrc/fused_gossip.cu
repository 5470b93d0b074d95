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
//   The state stays in device memory, ping-ponging two f32 buffers (a bf16
//   state is widened first, exactly); each step is a tiled product of
//   [128 x 256] output tiles, one CTA of 16 x 16 threads of 8 x 16 blocks
//   per SM (128 sums a thread, up to 255 registers), W_t^T (the
//   transposed copy) and the state streamed by cp.async, with no register
//   staging, through a 3-stage ring of 32-k stages (144 KB), one barrier
//   per stage.  No split-K.
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
//   N > 1024.  The state is cast to bf16 once into the wrapper's scratch
//   (rows padded to a multiple of 256 columns, so every copy is 16 bytes)
//   and stays there between steps; each step is a tiled product of
//   [128 x 256] output tiles on wgmma (two warpgroups of m64n256k16, both
//   operands from 128-byte-swizzled shared memory, a 3-stage ring of 64-k
//   stages).  wgmma sums each element's k16 products in the mainloop's
//   order with the mma.sync bits, so it equals the shared-memory path
//   bitwise.
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
// operations (2.1 ms at the FP32 rate), which the card overlaps across
// CTAs; at N = 4095 an f32 step is 137 ms of FP32 operations and a bf16
// step 9.3 ms of tensor-core operations.  The per-step FMA kernel spends
// 6 LDS.128 per 128 FMAs.  Measured times: PERF.md.
//
// Shared memory: the FMA chain 4*(N*tile + 3*K*R) B, K = 32 for R <= 64
// else 16 (at most 112 KB: two CTAs per SM); the per-step FMA kernel 144
// KB (3 stages of 32 x (128 + 256) floats), the per-step tensor cores 145
// KB (3 stages of 64 x (128 + 256) bf16 and 1 KB to align the ring); the
// tensor cores' mainloop 2*(rings*3*R*32 + 2*Npad*tile) B, R the rows of
// a pass (64*MT), one ring unsplit, two split.  A CTA may use 227 KB, so
// that mainloop is bounded (at tile 32 about 1,424 workers, 1,000
// split); the wrapper sends N > 1024 one step at a time, and the split
// probe keeps its cap.  Device memory the wrapper allocates per call
// (fused_gossip_scratch_bytes): the transposed f32 stack (FMA chain and
// per-step FMA) and the states the per-step paths read and write between
// steps (f32 [N][D] for FMA, bf16 [Npad][D rounded up to 256] for the
// tensor cores).  The
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

// Columns (col, col + 1) of row r (rows ld apart) as f32, zero past d:
// one pair access where `vec` says every row's pair is aligned (even ld
// and an aligned base), else scalars.
template <typename StateT>
__device__ __forceinline__ float2 load_pair(const StateT* __restrict__ x,
                                            long long r, long long ld,
                                            long long d, long long col,
                                            int vec) {
  const StateT* p = x + r * ld + col;
  if (vec && col + 1 < d) return Dtype<StateT>::load2(p);
  return make_float2(col < d ? Dtype<StateT>::load(p) : 0.0f,
                     col + 1 < d ? Dtype<StateT>::load(p + 1) : 0.0f);
}

template <typename StateT>
__device__ __forceinline__ float2 load_pair(const StateT* __restrict__ x,
                                            long long r, long long d,
                                            long long col, int vec) {
  return load_pair(x, r, d, d, col, vec);
}

template <typename StateT>
__device__ __forceinline__ void store_pair(StateT* __restrict__ out,
                                           long long r, long long ld,
                                           long long d, long long col,
                                           int vec, float a, float b) {
  StateT* p = out + r * ld + col;
  if (vec && col + 1 < d) {
    Dtype<StateT>::store2(p, a, b);
    return;
  }
  if (col < d) Dtype<StateT>::store(p, a);
  if (col + 1 < d) Dtype<StateT>::store(p + 1, b);
}

template <typename StateT>
__device__ __forceinline__ void store_pair(StateT* __restrict__ out,
                                           long long r, long long d,
                                           long long col, int vec, float a,
                                           float b) {
  store_pair(out, r, d, d, col, vec, a, b);
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

// BYTES (4 or 8) from global `src` to shared `dst`, or zeros where `valid`
// is false (src-size 0: nothing is read)
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}

// A per-step path's first input: the state rounded to bf16 (tensor cores)
// or widened to f32 (FMA, a bf16 state) into the wrapper's scratch:
// y[r][c] = x[r][c] for r < n, c < d, rows ld_x and ld_y apart, as pairs
// where each side's pairs are aligned.  One thread a column pair; the
// grid's rows stride over the state's.
template <typename InT, typename OutT>
__global__ void cast_rows(const InT* __restrict__ x, long long ld_x,
                          int vec_x, OutT* __restrict__ y, long long ld_y,
                          int vec_y, int n, long long d) {
  const long long col =
      2 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (col >= d) return;
  for (int r = blockIdx.y; r < n; r += gridDim.y) {
    const float2 v = load_pair(x, r, ld_x, d, col, vec_x);
    store_pair(y, r, ld_y, d, col, vec_y, v.x, v.y);
  }
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
// The per-step kernel: a [kStepRows x kStepCols] output tile per CTA, 16
// row groups of 8 rows by 16 column lanes of kStepTn = 16 columns (one CTA
// of 256 threads per SM, up to 255 registers: 128 sums a thread), and a
// ring of kStepStages stages of kStepK k values in dynamic shared memory
constexpr int kStepRows = 128, kStepCols = 256, kStepTn = 16;
constexpr int kStepK = 32, kStepStages = 3;

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

constexpr size_t kStepSmemBytes =
    sizeof(float) * kStepStages * kStepK * (kStepRows + kStepCols);

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

// One k of a per-step thread's 8 x 16 block: rows 8g .. 8g+7 of W^T row
// `wk` (wk points at 8g) and columns {4l + 64q : q < 4} (+0..3) of state
// row `xk` (xk points at 4l): 6 LDS.128, 128 FMAs, each the next link of
// its element's chain acc = fma(W[i,k], x[k], acc).
__device__ __forceinline__ void fma_step_k(float (&acc)[kBlock][kStepTn],
                                           const float* wk, const float* xk) {
  const float4 w0 = *reinterpret_cast<const float4*>(wk);
  const float4 w1 = *reinterpret_cast<const float4*>(wk + 4);
  const float wv[kBlock] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  float xv[kStepTn];
#pragma unroll
  for (int q = 0; q < kStepTn / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(xk + 64 * q);
    xv[4 * q] = v.x;
    xv[4 * q + 1] = v.y;
    xv[4 * q + 2] = v.z;
    xv[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int r = 0; r < kBlock; ++r) {
#pragma unroll
    for (int c = 0; c < kStepTn; ++c) {
      acc[r][c] = __fmaf_rn(wv[r], xv[c], acc[r][c]);
    }
  }
}

// One step of the large-N path: dst = W_t @ src for a [128 x 256] output
// tile per CTA, 16 x 16 threads of 8 x 16 blocks (rows 8g.., columns
// {4l + 64q}).  src is an f32 state (a bf16 state is widened first, which
// is exact), rows ld_src floats apart; dst takes OutT, rows ld_dst apart,
// and ROUND rounds each sum to bf16 first (an intermediate step of a bf16
// state, kept in f32 for the next step).  W_t^T (the transposed copy,
// [k][ldw]) and src stream through a ring of 3 stages of 32 k values in
// dynamic shared memory, filled by cp.async two stages ahead with no
// register staging: W^T as 16-byte copies, the state as 8-byte copies
// where its rows' pairs are aligned (src_vec) and 4-byte ones otherwise
// (an f32 row of even D is only 8-byte aligned: no 16-byte copy, and no
// TMA, takes it), zeros past d.  One barrier per stage.  In a whole
// stage each thread copies the same granules of every stage, so its two
// source pointers only step by 32 rows.  The row tiles go fastest, so the
// CTAs in flight share their column slabs of the state.  k runs 0 .. n-1
// in order and never past n, so every element is the chain's sum
// bitwise; rows past n are summed but never stored.
template <typename OutT, bool ROUND>
__global__ void __launch_bounds__(kThreads, 1)
    fma_step_kernel(const float* __restrict__ src, long long ld_src,
                    int src_vec, OutT* __restrict__ dst, long long ld_dst,
                    int dst_vec, const float* __restrict__ wt, int n, int ldw,
                    long long d) {
  constexpr int CL = 16;                   // column lanes
  constexpr int BM = kStepRows, BN = kStepCols, KB = kStepK;
  constexpr int S = kStepStages;
  constexpr int kWSlot = KB * BM;          // floats of a W^T stage
  constexpr int kXSlot = KB * BN;          // floats of a state stage
  static_assert(kThreads == CL * BM / kBlock && BN == CL * kStepTn,
                "16 x 16 threads of 8 x 16 blocks");
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;              // [S][KB][BM]
  float* xs = smem + S * kWSlot;  // [S][KB][BN]
  const int l = threadIdx.x % CL, g = threadIdx.x / CL;

  const int row_tiles = (n + BM - 1) / BM;
  const int row0 = static_cast<int>(blockIdx.x % row_tiles) * BM;
  const long long col0 = static_cast<long long>(blockIdx.x / row_tiles) * BN;

  const int kchunks = (n + KB - 1) / KB;
  // a whole stage: thread t copies W^T granule (w_kk + j*kWStep, w_r) and
  // state pair (x_kk + j*kXStep, x_cc) of every stage
  constexpr int kWCopies = KB * BM / 4 / kThreads;
  constexpr int kXPairs = KB * BN / 2 / kThreads;
  constexpr int kWStep = kThreads / (BM / 4), kXStep = kThreads / (BN / 2);
  static_assert(kWCopies * kWStep == KB && kXPairs * kXStep == KB,
                "a stage is whole granules a thread");
  const int w_kk = threadIdx.x / (BM / 4), w_r = 4 * (threadIdx.x % (BM / 4));
  const int x_kk = threadIdx.x / (BN / 2), x_cc = 2 * (threadIdx.x % (BN / 2));
  const bool x_in = col0 + x_cc < d;
  const float* w_at = wt + static_cast<size_t>(w_kk) * ldw + row0 + w_r;
  const float* x_at = src + x_kk * ld_src + (x_in ? col0 + x_cc : 0);
  const long long w_step = static_cast<long long>(kWStep) * ldw;
  const long long x_step = kXStep * ld_src;
  auto fetch = [&](int c) {
    if (c < kchunks) {
      const int k0 = c * KB;
      const int klen = min(KB, n - k0);
      float* wdst = ws + (c % S) * kWSlot;
      float* xdst = xs + (c % S) * kXSlot;
      if (klen == KB && src_vec) {
        const float* wp = w_at + static_cast<long long>(k0) * ldw;
        const float* xp = x_at + k0 * ld_src;
        float* wd = wdst + w_kk * BM + w_r;
        float* xd = xdst + x_kk * BN + x_cc;
#pragma unroll
        for (int j = 0; j < kWCopies; ++j) {
          cp_async16(wd + j * kWStep * BM, wp + j * w_step);
        }
#pragma unroll
        for (int j = 0; j < kXPairs; ++j) {
          cp_async_zfill<8>(xd + j * kXStep * BN, xp + j * x_step, x_in);
        }
      } else {  // the last stage (klen < KB), or rows not pair-aligned
        const float* wsrc = wt + static_cast<size_t>(k0) * ldw + row0;
        const float* xsrc = src + k0 * ld_src;
        for (int q = threadIdx.x; q < klen * (BM / 4); q += kThreads) {
          const int kk = q / (BM / 4), r = 4 * (q % (BM / 4));
          cp_async16(wdst + kk * BM + r,
                     wsrc + static_cast<size_t>(kk) * ldw + r);
        }
        if (src_vec) {
          for (int q = threadIdx.x; q < klen * (BN / 2); q += kThreads) {
            const int kk = q / (BN / 2), cc = 2 * (q % (BN / 2));
            const bool in = col0 + cc < d;
            cp_async_zfill<8>(xdst + kk * BN + cc,
                              xsrc + kk * ld_src + (in ? col0 + cc : 0), in);
          }
        } else {
          for (int q = threadIdx.x; q < klen * BN; q += kThreads) {
            const int kk = q / BN, cc = q % BN;
            const bool in = col0 + cc < d;
            cp_async_zfill<4>(xdst + kk * BN + cc,
                              xsrc + kk * ld_src + (in ? col0 + cc : 0), in);
          }
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[kBlock][kStepTn];
#pragma unroll
  for (int r = 0; r < kBlock; ++r) {
#pragma unroll
    for (int c = 0; c < kStepTn; ++c) acc[r][c] = 0.0f;
  }
  // a thread whose 8 rows all lie past n sums nothing
  const bool idle = row0 + 8 * g >= n;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) fetch(s);
  for (int c = 0; c < kchunks; ++c) {
    cp_async_wait<S - 2>();  // this thread's part of stage c landed
    __syncthreads();         // all of stage c; the slot of stage c-1 is free
    fetch(c + S - 1);
    const float* w = ws + (c % S) * kWSlot + 8 * g;
    const float* x = xs + (c % S) * kXSlot + 4 * l;
    const int klen = min(KB, n - c * KB);
    if (idle) {
    } else if (klen == KB) {
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        fma_step_k(acc, w + kk * BM, x + kk * BN);
      }
    } else {
#pragma unroll 1
      for (int kk = 0; kk < klen; ++kk) {
        fma_step_k(acc, w + kk * BM, x + kk * BN);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < kBlock; ++r) {
    const int i = row0 + 8 * g + r;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < kStepTn; c += 2) {
      const long long col = col0 + 64 * (c / 4) + 4 * l + c % 4;
      float a = acc[r][c], b = acc[r][c + 1];
      if (ROUND) {
        a = Dtype<__nv_bfloat16>::round(a);
        b = Dtype<__nv_bfloat16>::round(b);
      }
      store_pair(dst, i, ld_dst, d, col, dst_vec, a, b);
    }
  }
}

}  // namespace fp32

// ---------------------------------------------- wgmma (sm_90a) helpers

// A shared-memory matrix descriptor with 128-byte swizzling: start address,
// the byte offsets between core-matrix groups along the leading (lbo) and
// the stride (sbo) dimension, layout type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lbo,
                                               int sbo) {
  return ((static_cast<uint64_t>(smem_u32(p)) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A (64 x 16, K-major) * B (16 x 256, N-major: tnspB = 1), f32
// accumulation, both from shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

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

// One step of the large-N path on the tensor cores: dst = W_t @ src for
// a [128 rows x 256 columns] output tile per CTA, on wgmma.  Two
// warpgroups each run m64n256k16 on their 64 rows, both operands read by
// the tensor cores from shared memory, the f32 sums in registers (128 a
// thread).  src is the state already rounded to bf16 in the wrapper's
// scratch ([npad][ldx], ldx a multiple of the tile width, rows past n
// zero): the first step's is cast by cast_rows, every other step's is
// written by the step before, rounded as the next step rounds its input.
// So the mainloop moves only 16-byte cp.async copies of W_t (the
// zero-padded bf16 stack) and of src, in stages of 64 k through a ring of
// 3 stages (48 KB each) in dynamic shared memory, two stages ahead, one
// barrier and 4 wgmma per warpgroup a stage.  W_t's stage is K-major and
// the state's N-major, both in wgmma's 128-byte-swizzled layouts (the
// 16-byte granules of each 128-byte row XORed with the row's low 3 bits),
// each stage on a 1024-byte boundary.  Each output element's k16 products
// are summed from 0 in k order, k < npad: wgmma gives the bits the
// mainloop's mma.sync gives (checked on the card for m64n64k16 and for
// this kernel against tc_gossip_kernel), so this path equals the
// shared-memory path bitwise.  The row tiles go fastest: the CTAs in
// flight share their columns of the state, read from device memory once,
// while the bf16 stack (33.5 MB at N = 4095) stays in L2.  dst takes
// OutT, rows ld_dst apart (the caller's out for the last step, masked past
// n and d; the next step's bf16 src otherwise).
constexpr int kStepRows = 128, kStepCols = 256;
constexpr int kStepK = 64, kStepStages = 3;
// the ring, and room to start it on a 1024-byte boundary
constexpr size_t kStepSmemBytes =
    sizeof(bf16) * kStepStages * kStepK * (kStepRows + kStepCols) + 1024;

__host__ __device__ inline long long step_ldx(long long d) {
  return (d + kStepCols - 1) / kStepCols * kStepCols;
}

// Element (r, k) of a [kStepRows][kStepK] W stage (K-major, 128-byte rows):
// the 8 granules of a row XORed with the row's low 3 bits.
__device__ __forceinline__ int step_w_idx(int r, int k) {
  return r * kStepK + ((((k >> 3) ^ r) & 7) << 3) + (k & 7);
}

// Element (k, c) of a [kStepK][kStepCols] state stage (N-major): 64-column
// segments of kStepK rows of 128 B (8 KB each), the granules of a row
// XORed with k's low 3 bits.
__device__ __forceinline__ int step_x_idx(int k, int c) {
  return (c >> 6) * (kStepK * 64) + k * 64 + ((((c >> 3) ^ k) & 7) << 3) +
         (c & 7);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    tc_step_kernel(const bf16* __restrict__ src, long long ldx,
                   OutT* __restrict__ dst, long long ld_dst, int dst_vec,
                   const bf16* __restrict__ w, int n, long long d) {
  constexpr int ROWS = kStepRows, COLS = kStepCols, S = kStepStages;
  constexpr int kWSlot = ROWS * kStepK;  // bf16 of a W stage (16 KB)
  constexpr int kXSlot = kStepK * COLS;  // bf16 of a state stage (32 KB)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzling repeats every 1024 B: stages start on a multiple
  bf16* ws = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* xs = ws + S * kWSlot;
  const int npad = pad16(n);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row_tiles = (npad + ROWS - 1) / ROWS;
  const int row0 = static_cast<int>(blockIdx.x % row_tiles) * ROWS;
  const long long col0 =
      static_cast<long long>(blockIdx.x / row_tiles) * COLS;
  const int kchunks = (npad + kStepK - 1) / kStepK;
  // a warpgroup whose 64 rows all lie past npad has no products (rows past
  // npad in a live warpgroup read stage rows never loaded: their sums are
  // never stored, and no other row reads them)
  const bool live = row0 + 64 * wg < npad;

  auto fetch = [&](int c) {
    if (c < kchunks) {
      const int k0 = c * kStepK;
      const int klen = min(kStepK, npad - k0);  // a multiple of 16
      bf16* wdst = ws + (c % S) * kWSlot;
      bf16* xdst = xs + (c % S) * kXSlot;
#pragma unroll
      for (int j = 0; j < ROWS * kStepK / 8 / kThreads; ++j) {
        const int q = threadIdx.x + j * kThreads;
        const int r = q / (kStepK / 8), k = 8 * (q % (kStepK / 8));
        if (row0 + r < npad && k < klen) {
          cp_async16(wdst + step_w_idx(r, k),
                     w + static_cast<size_t>(row0 + r) * npad + k0 + k);
        }
      }
#pragma unroll
      for (int j = 0; j < kStepK * COLS / 8 / kThreads; ++j) {
        const int q = threadIdx.x + j * kThreads;
        const int k = q / (COLS / 8), cc = 8 * (q % (COLS / 8));
        if (k < klen) {
          cp_async16(xdst + step_x_idx(k, cc),
                     src + static_cast<size_t>(k0 + k) * ldx + col0 + cc);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) fetch(s);
  for (int c = 0; c < kchunks; ++c) {
    cp_async_wait<S - 2>();  // this thread's part of stage c landed
    // the tensor cores read through the async proxy what cp.async wrote
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // all of stage c; stage c-1's products are done
    fetch(c + S - 1);
    if (live) {
      const bf16* wb = ws + (c % S) * kWSlot + 64 * wg * kStepK;
      const bf16* xb = xs + (c % S) * kXSlot;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kStepK / kK; ++s) {
        if (c * kStepK + s * kK >= npad) break;
        // A: 8-row groups 1024 B apart, a k16 block 32 B on in the
        // swizzled rows; B: 64-column segments 8 KB apart, 8-k groups
        // 1024 B apart, a k16 block 2 KB on
        wgmma_m64n256k16(acc, sw128_desc(wb + s * kK, 16, 1024),
                         sw128_desc(xb + s * kK * 64, kStepK * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();  // the slot is refilled after the next barrier
    }
  }
  cp_async_wait<0>();
  // accumulator i of a thread: n8 block i/4, row 16*warp + lane/4 (+8 for
  // i%4 >= 2), columns 2*(lane%4) + i%2 -- the m16n8 fragment of each n8
  // block, as mma.sync lays it out
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    const int r =
        row0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    const long long col = col0 + 8 * (i >> 2) + 2 * (lane & 3);
    if (r < n) {
      store_pair(dst, r, ld_dst, d, col, dst_vec, acc[i], acc[i + 1]);
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
// 0 and 5), then, on the per-step paths, the states they read and write
// between steps.  Path 5 keeps them as f32 [n][d] (a bf16 state is widened
// for step 0 and rounded to bf16 values between steps): min(t, 2) buffers
// for a bf16 state, min(t - 1, 2) for an f32 one, which step 0 reads in
// place.  Path 6 keeps them as bf16 [npad][ldx], rows past n zero (step
// 0's input cast, then the states between steps): min(t, 2).
size_t wt_bytes(int n, int t_steps, int ldw) {
  return align256(sizeof(float) * static_cast<size_t>(t_steps) * n * ldw);
}

int step_buffers(int path, int t_steps, int state_dtype) {
  const int b = path == kFmaStep && state_dtype == 0 ? t_steps - 1 : t_steps;
  return b < 2 ? b : 2;
}

size_t step_buffer_bytes(int path, int n, long long d) {
  return path == kFmaStep
             ? align256(sizeof(float) * static_cast<size_t>(n) * d)
             : align256(sizeof(tc::bf16) * static_cast<size_t>(tc::pad16(n)) *
                        tc::step_ldx(d));
}

long long scratch_bytes(int n, long long d, int t_steps, int path, int tile,
                        int state_dtype) {
  switch (path) {
    case kFma:
      return static_cast<long long>(
          wt_bytes(n, t_steps, fp32::chain_rows(tile)));
    case kFmaStep:
    case kTcStep:
      return static_cast<long long>(
          (path == kFmaStep ? wt_bytes(n, t_steps, fp32::step_ldw(n)) : 0) +
          step_buffers(path, t_steps, state_dtype) *
              step_buffer_bytes(path, n, d));
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

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// A per-step path's first input, x[n, d] (pairs aligned where vec_x),
// cast to y (rows ld_y apart, pairs aligned where vec_y).
template <typename InT, typename OutT>
cudaError_t cast(const InT* x, int vec_x, OutT* y, long long ld_y, int vec_y,
                 int n, long long d, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((d + 511) / 512),
                  n < 1024 ? n : 1024);
  cast_rows<InT, OutT><<<grid, 256, 0, s>>>(x, d, vec_x, y, ld_y, vec_y, n,
                                            d);
  return cudaGetLastError();
}

// One step of path 5.
template <typename OutT, bool ROUND>
cudaError_t fma_step(const float* src, int src_vec, OutT* dst, int dst_vec,
                     const float* wt, int n, int ldw, long long d,
                     cudaStream_t s) {
  auto kernel = fp32::fma_step_kernel<OutT, ROUND>;
  constexpr size_t smem = fp32::kStepSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((n + fp32::kStepRows - 1) / fp32::kStepRows) *
      ((d + fp32::kStepCols - 1) / fp32::kStepCols);
  kernel<<<static_cast<unsigned>(blocks), fp32::kThreads, smem, s>>>(
      src, d, src_vec, dst, d, dst_vec, wt, n, ldw, d);
  return cudaGetLastError();
}

// Path 5: step t reads x (t = 0; a bf16 state widened to f32 first) or
// the buffer step t-1 wrote, and writes out (the last step) or the other
// buffer.
template <typename StateT>
cudaError_t fma_steps(const StateT* x, StateT* out, const float* stack,
                      unsigned char* scratch, int n, long long d,
                      int t_steps, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(StateT) == 2;
  const int ldw = fp32::step_ldw(n);
  float* wt = reinterpret_cast<float*>(scratch);
  const size_t at = wt_bytes(n, t_steps, ldw);
  const size_t state = step_buffer_bytes(kFmaStep, n, d);
  float* bufs[2] = {reinterpret_cast<float*>(scratch + at),
                    reinterpret_cast<float*>(scratch + at + state)};
  cudaError_t err = transpose(stack, wt, n, ldw, t_steps, s);
  if (err != cudaSuccess) return err;
  const int even = d % 2 == 0;
  const float* src = reinterpret_cast<const float*>(x);
  int src_vec = even && aligned(x, 2 * sizeof(StateT));
  int b = 0;
  if (kBf16) {
    err = cast(x, src_vec, bufs[0], d, even, n, d, s);
    if (err != cudaSuccess) return err;
    src = bufs[0];
    src_vec = even;
    b = 1;
  }
  for (int t = 0; t < t_steps; ++t) {
    const float* w = wt + static_cast<size_t>(t) * n * ldw;
    if (t + 1 == t_steps) {
      return fma_step<StateT, false>(src, src_vec, out,
                                     even && aligned(out, 2 * sizeof(StateT)),
                                     w, n, ldw, d, s);
    }
    err = fma_step<float, kBf16>(src, src_vec, bufs[b], even, w, n, ldw, d,
                                 s);
    if (err != cudaSuccess) return err;
    src = bufs[b];
    src_vec = even;
    b ^= 1;
  }
  return cudaSuccess;
}

// One step of path 6.
template <typename OutT>
cudaError_t tc_step(const tc::bf16* src, long long ldx, OutT* dst,
                    long long ld_dst, int dst_vec, const tc::bf16* w, int n,
                    long long d, cudaStream_t s) {
  auto kernel = tc::tc_step_kernel<OutT>;
  constexpr size_t smem = tc::kStepSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((tc::pad16(n) + tc::kStepRows - 1) /
                             tc::kStepRows) *
      (ldx / tc::kStepCols);
  kernel<<<static_cast<unsigned>(blocks), tc::kThreads, smem, s>>>(
      src, ldx, dst, ld_dst, dst_vec, w, n, d);
  return cudaGetLastError();
}

// Path 6: the state cast to bf16 into buffer 0, then step t reads the
// buffer step t-1 wrote (rounded to bf16, as step t rounds its input) and
// writes out (the last step) or the other buffer.
template <typename StateT>
cudaError_t tc_steps(const StateT* x, StateT* out, const tc::bf16* stack,
                     unsigned char* scratch, int n, long long d, int t_steps,
                     cudaStream_t s) {
  const int npad = tc::pad16(n);
  const long long ldx = tc::step_ldx(d);
  const size_t state = step_buffer_bytes(kTcStep, n, d);
  tc::bf16* bufs[2] = {reinterpret_cast<tc::bf16*>(scratch),
                       reinterpret_cast<tc::bf16*>(scratch + state)};
  cudaError_t err = cudaSuccess;
  for (int b = 0; b < step_buffers(kTcStep, t_steps, 0); ++b) {
    if (npad > n) {  // the padded rows: zero k values of every step
      err = cudaMemsetAsync(bufs[b] + static_cast<size_t>(n) * ldx, 0,
                            sizeof(tc::bf16) * (npad - n) * ldx, s);
      if (err != cudaSuccess) return err;
    }
  }
  const int even = d % 2 == 0;
  err = cast(x, even && aligned(x, 2 * sizeof(StateT)), bufs[0], ldx, 1, n,
             d, s);
  if (err != cudaSuccess) return err;
  int b = 1;
  for (int t = 0; t < t_steps; ++t) {
    const tc::bf16* src = bufs[b ^ 1];
    const tc::bf16* w = stack + static_cast<size_t>(t) * npad * npad;
    if (t + 1 == t_steps) {
      return tc_step<StateT>(src, ldx, out, d,
                             even && aligned(out, 2 * sizeof(StateT)), w, n,
                             d, s);
    }
    err = tc_step<tc::bf16>(src, ldx, bufs[b], ldx, 1, w, n, d, s);
    if (err != cudaSuccess) return err;
    b ^= 1;
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

// The columns of a per-step path's (5 or 6) output tile, else -1.
long long fused_gossip_step_tile(int path) {
  return path == kFmaStep ? fp32::kStepCols
                          : (path == kTcStep ? tc::kStepCols : -1);
}

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
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    auto* buf = static_cast<unsigned char*>(scratch);
    using bf16 = __nv_bfloat16;
    if (path == kFmaStep) {
      const auto* w = static_cast<const float*>(stack);
      err = state_dtype == 0
                ? fma_steps(static_cast<const float*>(x),
                            static_cast<float*>(out), w, buf, n, d, t_steps,
                            s)
                : fma_steps(static_cast<const bf16*>(x),
                            static_cast<bf16*>(out), w, buf, n, d, t_steps,
                            s);
    } else {
      const auto* w = static_cast<const bf16*>(stack);
      err = state_dtype == 0
                ? tc_steps(static_cast<const float*>(x),
                           static_cast<float*>(out), w, buf, n, d, t_steps, s)
                : tc_steps(static_cast<const bf16*>(x), static_cast<bf16*>(out),
                           w, buf, n, d, t_steps, s);
    }
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
