// Permutation-form gossip on Hopper (sm_90a): T steps of matching exchanges
// on a worker-stacked state x[N, D].
//
// Replaces the TPU kernels of matcha_tpu/parallel/pallas_gossip.py:
//   perm_gossip_run (:389), dbuf=True  -> _make_perm_kernel_dbuf (:340)
//   perm_gossip_run (:389), dbuf=False -> _make_perm_kernel (:281)
// which both run _perm_window_body (:308).  One source; the template flag
// DBUF gives the two instantiations (perm_gossip_dbuf, perm_gossip_stream).
//
// What it computes.  Step t, with w = weights[t] (f32[M], alpha * flags,
// front-padded with zero rows to a multiple of w_window):
//   xw  = wire(x)                        (bf16 round trip, or x itself)
//   x_i = state(x_i + sum_j (w_j * gate[j,i]) * (xw[perm[j,i]] - xw_i))
// summed in f32 in j order, cast to the state dtype after every step.
// gate[j,i] = partnered * alive_i * alive_perm(i), folded by the wrapper.
//
// Design.  One CTA per column tile [N, tile].  The gathers move rows,
// never columns, so every value a column needs lies in that column: the
// whole T-step chain runs inside the CTA (the TPU kernel's sequential step
// axis becomes this loop; Hopper CTAs run in no order and carry nothing
// between them).  The state tile (as f32) and its wire image sit in shared
// memory as [row][column]; the CTA's threads are tile columns times
// (threads / tile) row groups, and a warp's 32 threads touch 32
// consecutive words (coalesced loads, no bank conflicts).  Row groups let
// a large N keep many warps in flight: the tile's shared memory grows with
// N, so the wrapper narrows the tile as N grows and fills the CTA with row
// groups instead.  Each step forms the wire image, then (after a barrier)
// updates every row from all M terms, then waits at a second barrier.  The
// M x N perms and gates are loaded once per CTA.  The weights stream
// window by window (w_window steps) through a 2-slot shared buffer: DBUF
// prefetches window k+1 with cp.async while window k is computed; without
// DBUF each window is loaded synchronously.  The ragged last tile (D is
// 273,258 on the main path) is masked per thread.
//
// What bounds it (H100 SXM, 3.35 TB/s, 67 TFLOP/s FP32).  At T=1 device
// memory: the tile is read once and written once, 2*N*D*4 B = 35 MB at
// N=16, D=273,258, about 10.4 us.  At T=64 the FP32 ALU: about
// (4M+2)*N*D*T operations.  Keeping the tile on chip for all T steps holds
// the memory traffic at 2*N*D*4 B whatever T is; the kernel sums every
// term, including those of inactive matchings, so at T=64 it does the
// (4M+2) operations per element and step that the plain version does.  The
// arithmetic is kept unfused (no FMA), one rounding per product and per
// sum, so the result is bitwise the plain PyTorch version (separate mul and
// add kernels), NaN and inf included.  The __fmul_rn/__fadd_rn/__fsub_rn
// intrinsics forbid contraction, and the file is also built with
// --fmad=false.
//
// Shared memory is 2*N*tile*4 B for the state and wire image, plus the
// gates, perms and weight slots.  A CTA may use 227 KB, so N is bounded
// (about 690 at tile=32 and M=10); the wrapper rejects larger N.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
struct StateIO;

template <>
struct StateIO<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float round(float v) { return v; }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <>
struct StateIO<__nv_bfloat16> {
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

template <bool WIRE_BF16>
__device__ __forceinline__ float to_wire(float v) {
  if constexpr (WIRE_BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

constexpr int kMaxSharedBytes = 232448;  // 227 KB per block on sm_90

__host__ __device__ inline size_t smem_bytes(int n, int tile, int w_window,
                                             int m) {
  // state and wire image, two weight windows, gates and perms
  return sizeof(float) * (2 * static_cast<size_t>(n) * tile +
                          2 * static_cast<size_t>(w_window) * m) +
         (sizeof(float) + sizeof(int)) * static_cast<size_t>(m) * n;
}

template <typename StateT, bool WIRE_BF16, bool DBUF>
__global__ void perm_gossip_kernel(const StateT* __restrict__ x,
                                   StateT* __restrict__ out,
                                   const float* __restrict__ weights,
                                   const int* __restrict__ perms,
                                   const float* __restrict__ gate, int n,
                                   long long d, int m, int n_windows,
                                   int w_window, int tile) {
  extern __shared__ float smem[];
  const int c = threadIdx.x % tile;       // column within the tile
  const int g = threadIdx.x / tile;       // row group: rows g, g+groups, ...
  const int groups = blockDim.x / tile;
  const int win_len = w_window * m;
  float* xs = smem;                                 // [n][tile] state
  float* xw = xs + static_cast<size_t>(n) * tile;   // [n][tile] wire image
  float* wbuf = xw + static_cast<size_t>(n) * tile; // [2][w_window * m]
  float* gs = wbuf + 2 * win_len;                   // [m][n]
  int* ps = reinterpret_cast<int*>(gs + m * n);     // [m][n]

  const long long col = static_cast<long long>(blockIdx.x) * tile + c;
  const bool live = col < d;

  for (int k = threadIdx.x; k < m * n; k += blockDim.x) {
    gs[k] = gate[k];
    ps[k] = perms[k];
  }
  if (live) {
    for (int r = g; r < n; r += groups) {
      xs[r * tile + c] = StateIO<StateT>::load(x + r * d + col);
    }
  }
  if (DBUF) {  // warm the pipeline: window 0 into slot 0
    for (int k = threadIdx.x; k < win_len; k += blockDim.x) {
      __pipeline_memcpy_async(wbuf + k, weights + k, sizeof(float));
    }
    __pipeline_commit();
  }

  for (int win = 0; win < n_windows; ++win) {
    const int slot = DBUF ? (win & 1) : 0;
    const float* wcur = wbuf + slot * win_len;
    if (DBUF) {
      if (win + 1 < n_windows) {
        // the other slot was last read in window win-1, whose last step
        // ended with a barrier, so refilling it cannot race a reader
        float* wnext = wbuf + (slot ^ 1) * win_len;
        const float* src = weights + static_cast<size_t>(win + 1) * win_len;
        for (int k = threadIdx.x; k < win_len; k += blockDim.x) {
          __pipeline_memcpy_async(wnext + k, src + k, sizeof(float));
        }
        __pipeline_commit();
        __pipeline_wait_prior(1);  // this window landed; the next may fly
      } else {
        __pipeline_wait_prior(0);
      }
    } else {
      const float* src = weights + static_cast<size_t>(win) * win_len;
      for (int k = threadIdx.x; k < win_len; k += blockDim.x) {
        wbuf[k] = src[k];
      }
    }
    __syncthreads();  // the window (and at win 0 the tables) visible to all

    for (int s = 0; s < w_window; ++s) {
      const float* w = wcur + s * m;
      if (live) {
        for (int r = g; r < n; r += groups) {
          xw[r * tile + c] = to_wire<WIRE_BF16>(xs[r * tile + c]);
        }
      }
      __syncthreads();  // the wire image visible to every row group
      if (live) {
        for (int i = g; i < n; i += groups) {
          const float xi = xw[i * tile + c];
          float acc = 0.0f;
          for (int j = 0; j < m; ++j) {
            const float coef = __fmul_rn(w[j], gs[j * n + i]);
            const float delta = __fsub_rn(xw[ps[j * n + i] * tile + c], xi);
            acc = __fadd_rn(acc, __fmul_rn(coef, delta));
          }
          xs[i * tile + c] =
              StateIO<StateT>::round(__fadd_rn(xs[i * tile + c], acc));
        }
      }
      __syncthreads();  // xw and this slot are read
    }
  }

  if (live) {
    for (int r = g; r < n; r += groups) {
      StateIO<StateT>::store(out + r * d + col, xs[r * tile + c]);
    }
  }
}

template <typename StateT, bool WIRE_BF16, bool DBUF>
cudaError_t launch(const void* x, void* out, const float* weights,
                   const int* perms, const float* gate, int n, long long d,
                   int m, int n_windows, int w_window, int tile, int threads,
                   cudaStream_t stream) {
  auto kernel = perm_gossip_kernel<StateT, WIRE_BF16, DBUF>;
  const size_t smem = smem_bytes(n, tile, w_window, m);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((d + tile - 1) / tile);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const StateT*>(x), static_cast<StateT*>(out), weights, perms,
      gate, n, d, m, n_windows, w_window, tile);
  return cudaGetLastError();
}

template <typename StateT>
cudaError_t dispatch_wire(bool wire_bf16, bool dbuf, const void* x, void* out,
                          const float* w, const int* p, const float* g, int n,
                          long long d, int m, int n_windows, int w_window,
                          int tile, int threads, cudaStream_t s) {
  auto run = [&](auto launcher) {
    return launcher(x, out, w, p, g, n, d, m, n_windows, w_window, tile,
                    threads, s);
  };
  if (wire_bf16) {
    return dbuf ? run(launch<StateT, true, true>)
                : run(launch<StateT, true, false>);
  }
  return dbuf ? run(launch<StateT, false, true>)
              : run(launch<StateT, false, false>);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes (the wrapper picks the tile).
long long perm_gossip_smem_bytes(int n, int tile, int w_window, int m) {
  return static_cast<long long>(smem_bytes(n, tile, w_window, m));
}

long long perm_gossip_smem_limit() { return kMaxSharedBytes; }

// Launch T = t_padded steps on x[n, d] into out[n, d] on `stream`: one
// CTA of `threads` threads per `tile` columns (threads / tile row groups).
// state_dtype / wire_dtype: 0 = float32, 1 = bfloat16 (wire 0 = no cast).
// Returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int perm_gossip_launch(const void* x, void* out, const void* weights,
                       const void* perms, const void* gate, int n,
                       long long d, int t_padded, int m, int w_window,
                       int tile, int threads, int state_dtype, int wire_dtype,
                       int dbuf, void* stream) {
  if (n < 1 || d < 1 || m < 1 || w_window < 1 || t_padded < 1 ||
      t_padded % w_window != 0 || tile < 32 || tile % 32 != 0 ||
      threads < tile || threads > 1024 || threads % tile != 0 ||
      smem_bytes(n, tile, w_window, m) > kMaxSharedBytes ||
      (state_dtype != 0 && state_dtype != 1) ||
      (wire_dtype != 0 && wire_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_windows = t_padded / w_window;
  const auto* w = static_cast<const float*>(weights);
  const auto* p = static_cast<const int*>(perms);
  const auto* g = static_cast<const float*>(gate);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      state_dtype == 0
          ? dispatch_wire<float>(wire_dtype == 1, dbuf != 0, x, out, w, p, g,
                                 n, d, m, n_windows, w_window, tile, threads, s)
          : dispatch_wire<__nv_bfloat16>(wire_dtype == 1, dbuf != 0, x, out, w,
                                         p, g, n, d, m, n_windows, w_window,
                                         tile, threads, s);
  return static_cast<int>(err);
}

const char* perm_gossip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
