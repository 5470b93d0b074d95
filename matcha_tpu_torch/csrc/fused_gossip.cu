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
//   16 < N <= 1024, unsplit (K3), or split (K4).  Redesigned for Hopper:
//   a producer and two consumer warpgroups.  The producer's first warp
//   loads W_t by TMA from a 3-D tensor map over the zero-padded stack
//   ([t][npad][npad], boxes of 64 k by the rows of a pass, 128-byte
//   swizzled, zero-filled past npad) into a ring of 2 to 4 stages, with a
//   full and an empty mbarrier per stage; the rest of the warpgroup hands
//   its registers to the consumers by setmaxnreg (232 a consumer thread).
//   The consumers run wgmma.m64nNk16 with both operands in shared memory
//   and the f32 sums in registers.  Every step rounds its input to bf16,
//   so the state tile lives in shared memory as bf16 for all T steps,
//   N-major in segments of a warpgroup's columns (64, or 32 and 16 where
//   it owns fewer, with the 128-, 64- or 32-byte swizzle), which makes it
//   wgmma's B operand as it stands: one buffer updated in place where a
//   step is one pass of rows, two otherwise.  A pass's sums become the next
//   step's state in the epilogue, a 4-byte store of a thread's two columns
//   (fence.proxy.async before the tensor cores read them), and the last
//   step writes the state's dtype to device memory, masked past n and d.
//   How the two warpgroups share a tile:
//     - unsplit (K3), tile 128, 64 or 32: warpgroup w owns rows [128w,
//       128w + 128) of each pass of 256 rows and all the tile's columns
//       (two m64 x tile products per k16 on one B); both read one ring
//       and meet at a 256-thread barrier per step.  Tile 256 (64 < N <=
//       128) and tile 128 at N <= 64: warpgroup w owns half the columns of
//       every row, one ring, and meets only at its own barrier; at N <= 64
//       the producer is a single warp and three CTAs share an SM.
//     - split (K4): warpgroup w owns column half w of a pass of 128 rows,
//       with its own ring (filled by producer lane w) and mbarriers, and
//       never waits on the other.  It reads every W_t from L2 twice as
//       often.
//   Every element's k16 products are summed from +0 in k order, k < npad,
//   as the parent's mma.sync mainloop and tc_step_kernel sum them, so
//   split equals unsplit bitwise, the tile width changes no bit, and this
//   path equals tc_step bitwise (chip_smoke.py holds both).  N is
//   zero-padded to a multiple of 16 in rows and in k (the wrapper pads the
//   stack; padded state rows are written as zero each step), and the
//   ragged last column tile is zero-filled on load and masked on store.
//   The tensor cores' f32 sum need not round like a chain of FMAs, so the
//   bf16 paths are held against the plain PyTorch version to one bf16 ulp
//   of the output, not bitwise.
// * Tensor cores one launch per step (tc_step_kernel): a bf16 stack and
//   N > 1024.  The state is cast to bf16 once into the wrapper's scratch
//   (rows padded to a multiple of 256 columns, so every copy is 16 bytes)
//   and stays there between steps; each step is a tiled product of
//   [128 x 256] output tiles on wgmma (two warpgroups of m64n256k16, both
//   operands from 128-byte-swizzled shared memory, a 3-stage ring of 64-k
//   stages).  wgmma sums each element's k16 products in the mainloop's
//   order, so it equals the shared-memory path bitwise.
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
// sums allow, the tensor cores' mainloop 128 columns at N = 256 (its 128
// sums a consumer thread), where (D/128)*T*N^2*2 B = 17.9 GB of L2 reads
// at T = 64 would take about 7.7 TB/s to keep pace with the tensor-core
// bound.  Measured, L2 did not bind it (a cluster of two CTAs sharing
// each stage by TMA multicast was slower: PERF.md); what does is a chain of
// latencies per step -- the stage's products, then the epilogue and the
// step's barrier with the tensor cores idle -- and shared memory, which
// serves both the TMA writes (32 B/clk at N = 256) and wgmma's operand
// reads (96 B/clk for m64n128k16) from its 128 B/clk.  So the design keeps
// the epilogue short (no branch per element, one 4-byte store a pair) and
// free of anything that makes ptxas serialize the wgmma (a wgmma under a
// thread-dependent test, stmatrix in the loop).  The per-step paths add a
// read and a write of the state per step (2*N*D*bytes, 0.33 ms at N = 512
// in f32) to a product of 2*N^2*D operations (2.1 ms at the FP32 rate),
// which the card overlaps across
// CTAs; at N = 4095 an f32 step is 137 ms of FP32 operations and a bf16
// step 9.3 ms of tensor-core operations.  The per-step FMA kernel spends
// 6 LDS.128 per 128 FMAs.  Measured times: PERF.md.
//
// Shared memory: the FMA chain 4*(N*tile + 3*K*R) B, K = 32 for R <= 64
// else 16 (at most 112 KB: two CTAs per SM); the per-step FMA kernel 144
// KB (3 stages of 32 x (128 + 256) floats), the per-step tensor cores 145
// KB (3 stages of 64 x (128 + 256) bf16 and 1 KB to align the ring); the
// tensor cores' mainloop (tc::layout) 1,152 + bufs*2*Npad*tile +
// rings*stages*R*128 B, R the rows of a pass (256 unsplit at tile <= 128,
// 64 at tile 128 where N <= 64, 128 otherwise), one ring unsplit, two
// split, 2 to 4 stages.  A CTA may use 227 KB, so that mainloop is
// bounded (at tile 32, 1,280 workers on either schedule); the wrapper
// sends N > 1024 one step at a time, and the split probe keeps its cap.
// Device memory the wrapper allocates per call
// (fused_gossip_scratch_bytes): the transposed f32 stack (FMA chain and
// per-step FMA) and the states the per-step paths read and write between
// steps (f32 [N][D] for FMA, bf16 [Npad][D rounded up to 256] for the
// tensor cores).  The
// register paths: the staged stack, at most 64 KB (window steps of
// 4*NR^2 or 512 B), plus two 2,304 B staging buffers per warp on the
// tensor cores.  Their grid comes from the occupancy API once per kernel,
// device and shared memory, and is kept (card_ctas): a launch sets no
// attribute after the first.

#include <cuda.h>  // CUtensorMap and its enums (no -lcuda: see encode_tiled)
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

// A shared-memory matrix descriptor: start address, the byte offsets
// between core-matrix groups along the leading (lbo) and the stride (sbo)
// dimension, the layout type in bits 62-63 (1: 128-byte swizzle, 2: 64,
// 3: 32); sw128_desc the 128-byte one.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo,
                                              int sbo, uint64_t type) {
  return ((static_cast<uint64_t>(smem_u32(p)) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (type << 62);
}

__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lbo,
                                               int sbo) {
  return smem_desc(p, lbo, sbo, 1);
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

constexpr int kThreads = 256;  // the per-step kernel: two warpgroups
constexpr int kK = 16;         // k values of one tensor-core product

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// ------------------------------------- the mainloop in shared memory

// Two consumer warpgroups and a producer: one warp where three CTAs share
// an SM (MB = 1), else a whole warpgroup, which gives its registers to the
// consumers by setmaxnreg.  An SM quadrant holds 64 KB of registers for
// the warps it runs: with three warps of a CTA on one quadrant, ptxas
// allows 168 registers a thread; the consumers of the 128 x 128 tile want
// more (128 sums and the epilogue), 232 once the producer warpgroup keeps
// 40.
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int MB>
constexpr int main_threads() {
  return kConsumers + (MB == 1 ? 32 : 128);
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

constexpr int kChunkK = 64;      // k values of a W stage: one 128-byte row
constexpr int kRowBytes = 128;   // a W stage row (64 bf16)
constexpr int kMaxStages = 4;    // W stages per ring, at most
constexpr int kMinStages = 2;    // fewer would leave no load in flight
constexpr size_t kAlignSlack = 1024;  // to start the ring on a 1024-B boundary
constexpr size_t kBarrierBytes = 128;  // the rings' full and empty mbarriers

// How a CTA's [rows x tile] output is cut between the two consumer
// warpgroups.  Unsplit by rows (K3 at tile <= 128): warpgroup w owns rows
// [w*64*mb, (w+1)*64*mb) of each pass of 128*mb rows and all tile columns
// (nw = tile).  By columns (K3 at tile 256, where 64 < N <= 128; K4's
// split schedule at every tile): warpgroup w owns columns [w*nw,
// (w+1)*nw) of all 64*mb rows of a pass (nw = tile / 2).  A warpgroup runs mb
// m64 x nw x k16 products per k16.  Where N <= 64 fits one m64 block, the
// tile is 128 columns by columns (mb = 1, nw = 64): 32 sums a thread leave
// room for three CTAs per SM, which a short chain's loads and stores want.
struct Plan {
  int mb, nw, rows;  // m64 blocks per warpgroup, its columns, rows a pass
  bool cols;
};

__host__ __device__ inline bool plan(int n, int tile, bool split, Plan* p) {
  if (split) {
    if (tile != 128 && tile != 64 && tile != 32) return false;
    *p = {2, tile / 2, 128, true};
  } else if (tile == 256) {
    if (pad16(n) <= 64) return false;
    *p = Plan{2, 128, 128, true};
  } else if (tile == 128 && pad16(n) <= 64) {  // one m64 block a pass
    *p = Plan{1, 64, 64, true};
  } else {
    if (tile != 128 && tile != 64 && tile != 32) return false;
    *p = {2, tile, 256, false};
  }
  return true;
}

// Shared memory of one CTA: the ring(s) of W stages ([rows of a pass] x
// 64 k, 128 B a row), then the state tile(s) (bf16, npad x tile), then the
// mbarriers.  One state buffer, updated in place, where a step is
// one pass; two (read one, write the other) where it takes more.  As many
// stages as fit, up to kMaxStages, and at least kMinStages: a tile whose
// total then passes the 227 KB a block may use is not launched.
struct Layout {
  int stages, bufs;
  size_t total;
};

__host__ __device__ inline bool layout(int n, int tile, bool split,
                                       Layout* l) {
  Plan p;
  if (n < 1 || !plan(n, tile, split, &p)) return false;
  const int npad = pad16(n);
  const size_t ring = (split ? 2 : 1) * static_cast<size_t>(p.rows) *
                      kRowBytes;  // a stage of each ring
  l->bufs = npad > p.rows ? 2 : 1;
  const size_t fixed = kAlignSlack + kBarrierBytes +
                       l->bufs * sizeof(bf16) * static_cast<size_t>(npad) *
                           tile;
  const size_t fit =
      fixed < static_cast<size_t>(kMaxSharedBytes)
          ? (kMaxSharedBytes - fixed) / ring
          : 0;
  l->stages = fit < kMinStages ? kMinStages
                               : (fit > kMaxStages ? kMaxStages
                                                   : static_cast<int>(fit));
  l->total = fixed + l->stages * ring;
  return true;
}

// The state tile, held N-major as wgmma's B operand: segments of SW
// columns (64 where a warpgroup owns 64 columns or more, else its NW), each
// npad rows (k) of 2*SW bytes, in the swizzle of that row width (128, 64 or
// 32 bytes: the 16-byte granules of a row XORed with address bits 7 and
// up), so a warpgroup's B operand is whole segments and a thread's two
// columns of one row are one 4-byte store.
template <int NW>
struct StateLayout {
  static constexpr int kSw = NW < 64 ? NW : 64;  // columns of a segment
  static constexpr int kRow = 2 * kSw;           // bytes of a segment row
  static constexpr int kMask = kSw == 64 ? 7 : (kSw == 32 ? 3 : 1);
  // wgmma's layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kType = kSw == 64 ? 1 : (kSw == 32 ? 2 : 3);
  static_assert(NW % kSw == 0 && kSw >= 16, "whole segments of 16 or more");

  // element (k, c) of a tile of npad rows
  __device__ static int idx(int k, int c, int npad) {
    int b = (c / kSw) * npad * kRow + k * kRow + (c % kSw) * 2;
    b ^= ((b >> 7) & kMask) << 4;
    return b >> 1;
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  A wait
// that outlasts kWaitPolls polls (each may suspend the thread for a
// while; tens of seconds in all) is a fault: it traps instead of hanging
// the card.
constexpr uint32_t kWaitPolls = 1u << 28;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == kWaitPolls) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// The box of W at (k0, row0, t) into shared memory, its bytes counted on
// `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int k0, int row0, int t,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(t),
      "r"(smem_u32(bar))
      : "memory");
}

// Plain stores to shared memory, made visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` among `count` threads (0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// d += A (64 x 16, K-major) * B (16 x N, N-major: tnspB = 1), both from
// swizzled shared memory (descriptors da, db), f32 accumulation.
template <int N>
struct WgmmaKN;

template <>
struct WgmmaKN<16> {
  __device__ __forceinline__ static void run(float (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaKN<32> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaKN<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaKN<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// The chain on a [rows x tile] column tile, one CTA per tile: a producer
// warp loads W_t by TMA into a ring of [rows of a pass] x 64-k stages (full
// and empty mbarriers), two consumer warpgroups run wgmma on them with the
// state tile, held as bf16 in shared memory for all T steps, as the B
// operand.  The f32 sums stay in registers (MB * NW / 2 a thread) until a
// pass's rows are summed; then they become the next step's state (bf16,
// into the other buffer, or in place when a step is one pass) or, on the
// last step, the output in the state's dtype.
template <int MB, int NW, bool COLS, bool SPLIT>
__global__ void __launch_bounds__(main_threads<MB>(), MB == 1 ? 3 : 1)
    tc_gossip_kernel(const __grid_constant__ CUtensorMap wmap,
                     const void* __restrict__ x, void* __restrict__ out,
                     int n, long long d, int t_steps, int state_bf16,
                     int vec, int stages, int bufs, int box_rows) {
  using SL = StateLayout<NW>;
  constexpr int TILE = COLS ? 2 * NW : NW;
  constexpr int P = COLS ? 64 * MB : 128 * MB;  // rows of a pass
  constexpr int kRings = SPLIT ? 2 : 1;
  constexpr int kStageBytes = P * kRowBytes;
  // the warps that release a ring's stage: both warpgroups, or one
  constexpr int kReleases = SPLIT ? 4 : 8;
  static_assert(!SPLIT || COLS, "a split warpgroup owns a column half");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzling repeats every 1024 B: stages and state segments
  // start on a multiple
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int npad = pad16(n);
  const int kchunks = (npad + kChunkK - 1) / kChunkK;
  const int passes = (npad + P - 1) / P;
  const int state_elems = npad * TILE;
  bf16* state0 = reinterpret_cast<bf16*>(ring + kRings * stages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(state0 + bufs * state_elems);
  uint64_t* empty = full + kRings * stages;
  const long long col0 = static_cast<long long>(blockIdx.x) * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kRings * stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kReleases);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // The producer: lane r of its first warp fills ring r with the flat
    // sequence of chunks (step t, pass p, 64-k chunk c), W_t's rows
    // [p*P, p*P + box_rows) by k [64c, 64c + 64); TMA zero-fills what
    // lies past npad.
    if constexpr (MB != 1) setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane < kRings) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      const uint32_t bytes = static_cast<uint32_t>(box_rows) * kRowBytes;
      unsigned char* mine = ring + lane * stages * kStageBytes;
      uint64_t* f = full + lane * stages;
      uint64_t* e = empty + lane * stages;
      int slot = 0;
      uint32_t phase = 0;
      for (int t = 0; t < t_steps; ++t) {
        for (int p = 0; p < passes; ++p) {
          for (int c = 0; c < kchunks; ++c) {
            mbar_wait(e + slot, phase ^ 1);  // the round before was read
            mbar_expect_tx(f + slot, bytes);
            tma_load(mine + slot * kStageBytes, &wmap, c * kChunkK, p * P, t,
                     f + slot);
            if (++slot == stages) {
              slot = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }
  if constexpr (MB != 1) setmaxnreg_inc<kConsumerRegs>();

  // The consumers.  Warpgroup wg takes this ring, these rows of a pass and
  // these columns of the tile.
  const int wg = threadIdx.x / 128, wwarp = warp % 4;
  const int rg = SPLIT ? wg : 0;
  const int row_off = COLS ? 0 : wg * 64 * MB;
  const int col_off = COLS ? wg * NW : 0;
  unsigned char* my_ring = ring + rg * stages * kStageBytes;
  uint64_t* f = full + rg * stages;
  uint64_t* e = empty + rg * stages;
  // a step's state writes meet the next step's reads: within the warpgroup
  // where it owns its columns, else across both
  auto meet = [&]() {
    if (COLS) {
      bar_sync(2 + wg, 128);
    } else {
      bar_sync(1, kConsumers);
    }
  };

  // the state tile, rounded to bf16: a thread moves columns (c, c+1) of a
  // row, one pair load where pairs are aligned (vec), kBatch of them in
  // flight; rows past n and columns past d are zero
  bf16* cur = state0;
  bf16* nxt = bufs == 2 ? state0 + state_elems : state0;
  constexpr int kBatch = 8;
  constexpr int kColPairs = TILE / 2;
  const int pairs = npad * kColPairs;
  for (int e0 = threadIdx.x; e0 < pairs; e0 += kBatch * kConsumers) {
    float2 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e2 = e0 + b * kConsumers;
      const int r = e2 / kColPairs;
      const long long col = col0 + 2 * (e2 % kColPairs);
      v[b] = make_float2(0.0f, 0.0f);
      if (e2 < pairs && r < n) {
        v[b] = state_bf16
                   ? load_pair(static_cast<const bf16*>(x), r, d, col, vec)
                   : load_pair(static_cast<const float*>(x), r, d, col, vec);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e2 = e0 + b * kConsumers;
      if (e2 < pairs) {
        *reinterpret_cast<__nv_bfloat162*>(
            cur + SL::idx(e2 / kColPairs, 2 * (e2 % kColPairs), npad)) =
            __floats2bfloat162_rn(v[b].x, v[b].y);
      }
    }
  }
  fence_async_smem();
  bar_sync(1, kConsumers);

  float acc[MB][NW / 2];
#pragma unroll
  for (int m = 0; m < MB; ++m) {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[m][i] = 0.0f;
  }
  const int g = lane >> 2, t4 = lane & 3;
  // B: this warpgroup's segments of the state, 8-row (k) groups 8 rows
  // apart, segments npad rows apart
  const int seg_bytes = npad * SL::kRow;
  const int seg0 = (col_off / SL::kSw) * seg_bytes;
  int slot = 0;
  uint32_t phase = 0;
  for (int t = 0; t < t_steps; ++t) {
    const bool last = t + 1 == t_steps;
    for (int p = 0; p < passes; ++p) {
      const int row0 = p * P + row_off;  // the warpgroup's first row
      int prev = -1;
      for (int c = 0; c < kchunks; ++c) {
        mbar_wait(f + slot, phase);
        const unsigned char* ws =
            my_ring + slot * kStageBytes + row_off * kRowBytes;
        const unsigned char* xs = reinterpret_cast<const unsigned char*>(cur) +
                                  seg0 + c * kChunkK * SL::kRow;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kChunkK / kK; ++s) {
          if (c * kChunkK + s * kK < npad) {
            const uint64_t db = smem_desc(xs + s * kK * SL::kRow, seg_bytes,
                                          8 * SL::kRow, SL::kType);
#pragma unroll
            for (int m = 0; m < MB; ++m) {
              // A: 8-row groups 1024 B apart, a k16 block 32 B on in the
              // swizzled rows.  An m64 block past npad has nothing to sum;
              // where the warpgroup's rows depend on the thread (by rows),
              // ptxas would serialize every wgmma behind such a test, so
              // there the block's discarded sums are taken.
              if (!COLS || row0 + m * 64 < npad) {
                WgmmaKN<NW>::run(
                    acc[m],
                    sw128_desc(ws + m * 64 * kRowBytes + s * 32, 16, 1024),
                    db);
              }
            }
          }
        }
        wgmma_commit();
        if (prev >= 0) {  // the chunk before is summed: free its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(e + prev);
        }
        prev = slot;
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(e + prev);
      // in place: every product of the step has read the state first
      if (!last && bufs == 1) meet();
      // accumulator v of a warp: n8 block v/4 of the m16n8 fragment at
      // rows 16*wwarp + g (+8 for v%4 >= 2), columns 2*t4 + v%2
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const int i0 = row0 + m * 64 + 16 * wwarp;  // the warp's 16 rows
        if (last) {
#pragma unroll
          for (int v = 0; v < NW / 2; v += 2) {
            const int i = i0 + g + 8 * ((v >> 1) & 1);
            const long long col = col0 + col_off + 8 * (v >> 2) + 2 * t4;
            const float a0 = acc[m][v], a1 = acc[m][v + 1];
            if (i >= n) continue;
            if (state_bf16) {
              store_pair(static_cast<bf16*>(out), i, d, d, col, vec, a0, a1);
            } else {
              store_pair(static_cast<float*>(out), i, d, d, col, vec, a0, a1);
            }
          }
        } else {
          // the next state, padded rows zero: row i0 + g (+8) of 8-column
          // group v/4, whose granule's swizzle is fixed by g
          const bool live = (!COLS || row0 + m * 64 < npad) && i0 < npad;
          const bool lo = i0 + g < n, hi = i0 + g + 8 < n;
          const int swz = ((g * SL::kRow) >> 7) & SL::kMask;
          unsigned char* base = reinterpret_cast<unsigned char*>(nxt) +
                                (col_off / SL::kSw) * seg_bytes +
                                (i0 + g) * SL::kRow + 4 * t4;
#pragma unroll
          for (int v = 0; v < NW / 2; v += 2) {
            const int grp = v >> 2, h = (v >> 1) & 1;
            const bool keep = h ? hi : lo;
            const __nv_bfloat162 pair = __floats2bfloat162_rn(
                keep ? acc[m][v] : 0.0f, keep ? acc[m][v + 1] : 0.0f);
            unsigned char* at =
                base + (grp * 8 / SL::kSw) * seg_bytes + 8 * h * SL::kRow +
                ((((grp * 8) % SL::kSw) / 8 ^ swz) << 4);
            if (live) *reinterpret_cast<__nv_bfloat162*>(at) = pair;
          }
        }
#pragma unroll
        for (int v = 0; v < NW / 2; ++v) acc[m][v] = 0.0f;
      }
    }
    if (!last) {  // the step's state is written: it is the next one's input
      fence_async_smem();
      meet();
      bf16* done = cur;
      cur = nxt;
      nxt = done;
    }
  }
}

// The tensor map over the zero-padded bf16 stack, [t][npad][npad]: a box is
// 64 k of `box_rows` rows of one step, 128-byte swizzled.  Three dimensions,
// so a box's rows past npad are zero-filled and never the next step's.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library links no -lcuda; null if the driver does not have it
EncodeTiled encode_tiled() {
  static std::once_flag once;
  static EncodeTiled fn = nullptr;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  });
  return fn;
}

cudaError_t stack_map(CUtensorMap* map, const void* stack, int npad,
                      int t_steps, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(npad),
                              static_cast<cuuint64_t>(npad),
                              static_cast<cuuint64_t>(t_steps)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(npad) * sizeof(bf16),
      static_cast<cuuint64_t>(npad) * npad * sizeof(bf16)};
  const cuuint32_t box[3] = {kChunkK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(stack),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int MB, int NW, bool COLS, bool SPLIT>
cudaError_t launch(const CUtensorMap& map, const Layout& l, int tile,
                   int box_rows, const void* x, void* out, int n, long long d,
                   int t_steps, int state_bf16, int vec, cudaStream_t stream) {
  auto kernel = tc_gossip_kernel<MB, NW, COLS, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.total));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((d + tile - 1) / tile);
  kernel<<<blocks, main_threads<MB>(), l.total, stream>>>(
      map, x, out, n, d, t_steps, state_bf16, vec, l.stages, l.bufs,
      box_rows);
  return cudaGetLastError();
}

// Paths 1 (unsplit) and 2 (split) at `tile` columns per CTA.
cudaError_t dispatch(bool split, int tile, const void* x, void* out,
                     const void* stack, int n, long long d, int t_steps,
                     int state_bf16, int vec, cudaStream_t s) {
  Plan p;
  Layout l;
  if (!plan(n, tile, split, &p) || !layout(n, tile, split, &l) ||
      reinterpret_cast<uintptr_t>(stack) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int npad = pad16(n);
  const int box_rows = npad < p.rows ? npad : p.rows;
  CUtensorMap map;
  cudaError_t err = stack_map(&map, stack, npad, t_steps, box_rows);
  if (err != cudaSuccess) return err;
  if (split) {
    switch (tile) {
      case 128:
        return launch<2, 64, true, true>(map, l, tile, box_rows, x, out, n, d,
                                         t_steps, state_bf16, vec, s);
      case 64:
        return launch<2, 32, true, true>(map, l, tile, box_rows, x, out, n, d,
                                         t_steps, state_bf16, vec, s);
      default:
        return launch<2, 16, true, true>(map, l, tile, box_rows, x, out, n, d,
                                         t_steps, state_bf16, vec, s);
    }
  }
  switch (tile) {
    case 256:
      return launch<2, 128, true, false>(map, l, tile, box_rows, x, out, n, d,
                                         t_steps, state_bf16, vec, s);
    case 128:
      return p.cols
                 ? launch<1, 64, true, false>(map, l, tile, box_rows, x, out,
                                              n, d, t_steps, state_bf16, vec,
                                              s)
                 : launch<2, 128, false, false>(map, l, tile, box_rows, x,
                                                out, n, d, t_steps,
                                                state_bf16, vec, s);
    case 64:
      return launch<2, 64, false, false>(map, l, tile, box_rows, x, out, n, d,
                                         t_steps, state_bf16, vec, s);
    default:
      return launch<2, 32, false, false>(map, l, tile, box_rows, x, out, n, d,
                                         t_steps, state_bf16, vec, s);
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
// are summed from 0 in k order, k < npad, as in tc_gossip_kernel's
// mainloop, so this path equals the shared-memory path bitwise (wgmma
// gives the bits mma.sync gave; chip_smoke.py holds the two paths
// bitwise).  The row tiles go fastest: the CTAs in
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
    ldsm_x4_trans(a[c], buf + ((mq >> 1) * 8 + mrow) * 2 * kStride +
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
          mma(acc[c][0], a[c], b.x, b.y);
          mma(acc[c][1], a[c], b.z, b.w);
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
  tc::Plan p;
  return path == kFma ? fp32::chain_takes(n, tile)
                      : tc::plan(n, tile, path == kSplit, &p);
}

size_t path_smem_bytes(int n, int tile, int path) {
  tc::Layout l;
  return path == kFma ? fp32::chain_smem_bytes(n, tile)
         : tc::layout(n, tile, path == kSplit, &l) ? l.total
                                                    : 0;
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
// Tiles: 64, 128, 256 and 512 on path 0 (n <= 16384 / tile); 32, 64, 128
// and 256 on path 1, 32, 64 and 128 on path 2 (the wrapper picks the tile;
// a tile whose bytes pass fused_gossip_smem_limit is not launched).
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
  } else {
    err = tc::dispatch(path == kSplit, tile, x, out, stack, n, d, t_steps,
                       state_dtype, vec, s);
  }
  return static_cast<int>(err);
}

const char* fused_gossip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
