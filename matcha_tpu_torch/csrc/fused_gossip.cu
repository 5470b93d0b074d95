// Fused W-stack gossip on Hopper (sm_90a): T steps of x <- W_t @ x on a
// worker-stacked state x[N, D], the state kept on chip for the whole chain.
//
// Replaces the TPU kernel of matcha_tpu/parallel/pallas_gossip.py:
//   fused_gossip_run (:182) -> _make_kernel (:156), pallas_call (:227)
//
// What it computes.  Step t, with W_t = stack[t] ([N, N], f32 or bf16, from
// build_mixing_stack, optionally composed):
//   x_i = state( sum_k W_t[i, k] * stackcast(x_k) )
// accumulated in f32, k = 0 .. N-1 in that order, one FMA per term.
// stackcast rounds the state to the stack dtype at each step's input and
// state() rounds the f32 sum to the state dtype at its output, as the TPU
// kernel casts (:164-176).  The wrapper front-pads the stack with identity
// matrices to a multiple of w_window (:221-225); the kernel runs the padded
// chain and stages one W_t at a time, so w_window changes no bit here.
//
// Design.  One CTA per column tile [N, tile]: columns of W_t @ x are
// independent, so the CTA loops over all T steps itself (the TPU kernel's
// sequential step axis becomes this loop).  The tile sits in shared memory
// twice, "cur" and "next", as f32 values already rounded to the stack
// dtype: step t+1 reads every row of step t's result, so the write cannot
// go in place.  Each thread accumulates an 8-row x 4-column register block
// in f32.  A warp's lanes form RL row groups of 32/RL column lanes (RL =
// 128/tile: 1, 2 or 4), so every tile width keeps the 8 x 4 block: per k
// a thread reads 8 W values as two float4 loads and 4 state values as
// words, then does 32 FMAs.  Each step walks the rows in passes of
// warps*RL*8 rows.  W_t streams through shared memory in chunks of 8 k
// values (chunks of 16 or 32 took more registers and more time at N = 256
// on an H100): read along k (coalesced) into registers one chunk ahead,
// stored transposed ([k][row], rows padded by 4 floats, two buffers) and
// converted to f32 while the next chunk's loads are in flight; one barrier
// per chunk.  Each output's sum runs over k in one fixed order whatever
// the tile, the pass or the chunk, so block_d (the tile cap) changes no
// bit either.  The last step writes the state-dtype result straight from
// registers to device memory.  The ragged last tile (D is 273,258 on the
// main path) is zero-filled on load and masked on store.
//
// Arithmetic.  FP32 FMA (__fmaf_rn, explicit: the port's kernels are built
// with --fmad=false, which does not touch the intrinsic) for both stack
// dtypes, never TF32.  A bf16 stack meets bf16 operands, so every product
// is exact in f32 and FP32 FMA is exactly "bf16 operands, f32
// accumulation".  The sum order may differ from cuBLAS's, so the kernel is
// held against the plain PyTorch version to rounding, not bitwise.
//
// What bounds it (H100 SXM: 67 TFLOP/s FP32, 989 TFLOP/s bf16 dense, 3.35
// TB/s).  The work is 2*N^2*D*T operations.  For an f32 stack the FP32 rate
// bounds it (TF32 would change the result); for a bf16 stack the tensor
// cores could do the same work about 15x faster, so this FP32-FMA kernel
// cannot reach the card's bound there: that is a later kernel's work
// (wgmma, TMA, a warp-specialised pipeline).  Device memory is read and
// written once per element of x (2*N*D*bytes) whatever T is.  W_t is
// re-read from L2 once per CTA and step, (D/tile)*T*N^2 elements in all --
// the counterpart of the TPU kernel's (D/block_d)*T*N^2 (:17) -- which is
// what sets the tile width: the wrapper takes the widest tile (at most 128
// columns) that leaves room for two CTAs on an SM.
//
// Shared memory is 4*(2*8*(rows+4) + 2*N*tile) B, rows = 8*RL*min(8,
// ceil(N/(8*RL))).  A CTA may use 227 KB, so N is bounded (about 840 at
// tile = 32); the wrapper rejects a larger N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerThread = 8;  // rows of a thread's register block
constexpr int kColsPerThread = 4;  // columns of a thread's register block
constexpr int kChunk = 8;          // k values of W_t staged at a time
constexpr int kPad = 4;  // floats after each k of the chunk: 4-way, not
                         // 32-way, bank conflicts on the transposing store
constexpr int kMaxWarps = 8;
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
template <typename StackT, int LOADS>
__device__ __forceinline__ void fetch_chunk(const StackT* __restrict__ w,
                                            int n, int row0, int k0,
                                            float (&reg)[LOADS]) {
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int e = threadIdx.x + l * blockDim.x;
    const int i = row0 + e / kChunk;
    const int k = k0 + e % kChunk;
    reg[l] = (i < n && k < n)
                 ? Dtype<StackT>::load(w + static_cast<size_t>(i) * n + k)
                 : 0.0f;
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

template <typename StateT, typename StackT, int RL>
__global__ void __launch_bounds__(kMaxWarps * 32)
    fused_gossip_kernel(const StateT* __restrict__ x, StateT* __restrict__ out,
                        const StackT* __restrict__ stack, int n, long long d,
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
    cur[e] = col < d
                 ? Dtype<StackT>::round(Dtype<StateT>::load(x + r * d + col))
                 : 0.0f;
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
            nxt[i * kTile + cl + kLanes * j] = Dtype<StackT>::round(s);
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

template <typename StateT, typename StackT, int RL>
cudaError_t launch(const void* x, void* out, const void* stack, int n,
                   long long d, int t_steps, cudaStream_t stream) {
  auto kernel = fused_gossip_kernel<StateT, StackT, RL>;
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
      static_cast<const StackT*>(stack), n, d, t_steps);
  return cudaGetLastError();
}

template <typename StateT, typename StackT>
cudaError_t dispatch_tile(int tile, const void* x, void* out,
                          const void* stack, int n, long long d, int t_steps,
                          cudaStream_t s) {
  switch (tile) {
    case 32:
      return launch<StateT, StackT, 4>(x, out, stack, n, d, t_steps, s);
    case 64:
      return launch<StateT, StackT, 2>(x, out, stack, n, d, t_steps, s);
    default:
      return launch<StateT, StackT, 1>(x, out, stack, n, d, t_steps, s);
  }
}

template <typename StateT>
cudaError_t dispatch_stack(bool stack_bf16, int tile, const void* x,
                           void* out, const void* stack, int n, long long d,
                           int t_steps, cudaStream_t s) {
  return stack_bf16 ? dispatch_tile<StateT, __nv_bfloat16>(
                          tile, x, out, stack, n, d, t_steps, s)
                    : dispatch_tile<StateT, float>(tile, x, out, stack, n, d,
                                                   t_steps, s);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes (the wrapper picks the tile).
long long fused_gossip_smem_bytes(int n, int tile) {
  return static_cast<long long>(smem_bytes(n, tile));
}

long long fused_gossip_smem_limit() { return kMaxSharedBytes; }

// Run t_steps steps of x[n, d] <- stack[t] @ x into out[n, d] on `stream`:
// one CTA of 32 * warps_for(n, tile) threads per `tile` (32, 64 or 128)
// columns.  state_dtype / stack_dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int fused_gossip_launch(const void* x, void* out, const void* stack, int n,
                        long long d, int t_steps, int tile, int state_dtype,
                        int stack_dtype, void* stream) {
  if (n < 1 || d < 1 || t_steps < 1 ||
      (tile != 32 && tile != 64 && tile != 128) ||
      smem_bytes(n, tile) > kMaxSharedBytes ||
      (state_dtype != 0 && state_dtype != 1) ||
      (stack_dtype != 0 && stack_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      state_dtype == 0
          ? dispatch_stack<float>(stack_dtype == 1, tile, x, out, stack, n, d,
                                  t_steps, s)
          : dispatch_stack<__nv_bfloat16>(stack_dtype == 1, tile, x, out,
                                          stack, n, d, t_steps, s);
  return static_cast<int>(err);
}

const char* fused_gossip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
