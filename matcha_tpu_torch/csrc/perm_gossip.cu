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
// Design.  The state is cut into column slabs [N, cols].  The gathers
// move rows, never columns, so every value a column needs lies in that
// column: the whole T-step chain of a slab runs inside one CTA (the TPU
// kernel's sequential step axis becomes this loop; Hopper CTAs run in no
// order and carry nothing between them).  A persistent grid (as many CTAs
// as fit on the card, at most kMaxCtasPerSm per SM) walks the slabs
// round-robin, so at any time the CTAs hold neighbouring slabs, whose rows
// share L2 sectors.  A thread owns up to R rows (g, g + groups, ...) of two
// adjacent columns and keeps them in registers, as f32, for all T steps;
// the lanes of a row lie along the columns, so global loads and stores are
// coalesced.  Per step a thread writes its rows' wire image, in the wire
// dtype (a bf16 image is exact in bf16), to a shared [N][cols] buffer;
// after one barrier it reads each partner's pair from
// there (8 bytes for an f32 wire, 4 for bf16; every lane of a row reads the
// same partner row, so the reads are conflict-free).  The image is
// double-buffered (nbuf = 2), so a step needs one barrier; where shared
// memory is short (large N) one buffer and a second barrier.  Each
// coefficient w_j * gate[j,i] is formed once per row and step, not per
// element; w_j is uniform across the CTA.  The tables (the template's
// TABLES) sit in shared memory, loaded once per CTA: as int2 {partner's
// offset in the image, gate bits}, or at large N as one uint16 per entry,
// (perm << 1) | (gate == 1), exact where every gate is 0 or 1 (else the
// gate is read from device memory).  The weights stream window by
// window (w_window steps) through a 2-slot shared buffer: DBUF prefetches
// window k+1 with cp.async while window k is computed; without DBUF each
// window is loaded synchronously at its start.  A single window stays
// resident from slab to slab.
//
// Skipping inactive terms, exactly.  A term whose coefficient is 0 adds
// (+-0) to an f32 accumulator that starts at +0; under round-to-nearest
// such a sum never becomes -0, so the term changes no bit, provided its
// delta is finite.  A zero coefficient times a non-finite delta is NaN, so
// a step skips zero-coefficient terms only when every value of the slab's
// wire image has |v| < 2^127 (then no difference of two overflows either),
// which the step's barrier decides for the whole CTA (__syncthreads_and).
// A whole matching is skipped, table reads included, when w_j is 0 and
// every gate is finite.
//
// Vector access.  A thread's pair of columns starts at an even column.  An
// f32 row starts at byte 4*D*r, so for even D every pair is 8-byte aligned
// (a bf16 pair 4-byte aligned) and moves as one access; an odd D (and a
// ragged last slab) takes scalar accesses.
//
// What bounds it (H100 SXM, 3.35 TB/s, 67 TFLOP/s FP32).  At T=1 device
// memory: the slab is read once and written once, 2*N*D*4 B = 35 MB at
// N=16, D=273,258, about 10.4 us.  At larger T the rate at which an SM
// issues shared-memory accesses and FP32 instructions: per active term
// and element one partner read, a subtract, a multiply and an add, and
// per row and term a table read and the coefficient.  The arithmetic is
// kept unfused (no FMA), one rounding per product and per sum, so the
// result is bitwise the plain PyTorch version (separate mul and add
// kernels), NaN and inf included.  The __fmul_rn/__fadd_rn/__fsub_rn
// intrinsics forbid contraction, and the file is also built with
// --fmad=false.  At N=4096 a slab is 4 columns wide (16 bytes of each
// row), which device memory serves poorly: the kernel is about 6x its
// byte bound there (PERF.md).
//
// Shared memory: nbuf * N * cols * wire bytes for the image, two weight
// windows, and the tables (8 or 2 bytes per entry).  A CTA holds at most
// 1024 threads, so N <= 1024 * R / (cols / 2): with R = 4 or 8 (rows past
// N are masked, so R = 4 takes N < 4 too) and two columns, N up to 8192,
// where the tables fit (M <= 10 at N = 8192).
//
// Launch.  The grid's size comes from the occupancy API once per
// instantiation, device, block size and shared memory, and is kept
// (card_ctas): a training step's T = 1 launch pays only the launch itself.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

namespace {

template <typename T>
struct StateIO;

template <>
struct StateIO<float> {
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
struct StateIO<__nv_bfloat16> {
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
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  }
};

// The wire image: its element type in shared memory, and a pair's store
// and load (values are exact in the wire type, so the f32 view is lossless).
template <bool WIRE_BF16>
struct Wire;

template <>
struct Wire<false> {
  using T = float;
  __device__ static float round(float v) { return v; }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  __device__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <>
struct Wire<true> {
  using T = __nv_bfloat16;
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    // a and b are bf16 values already: the conversion is exact
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  }
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

constexpr int kMaxSharedBytes = 232448;  // 227 KB per block on sm_90
constexpr int kMaxThreads = 1024;
// Resident CTAs per SM at most: more CTAs in flight beat an even last
// round (PERF.md).
constexpr int kMaxCtasPerSm = 8;
constexpr float kTame = 1.7014118346046923e38f;  // 2^127

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t image_bytes(int n, int cols, int wire_bf16,
                                              int nbuf) {
  return align16(static_cast<size_t>(nbuf) * n * cols * (wire_bf16 ? 2 : 4));
}

__host__ __device__ inline size_t weight_bytes(int w_window, int m) {
  return align16(sizeof(float) * 2 * static_cast<size_t>(w_window) * m);
}

// Table layouts in shared memory (the TABLES template argument): int2
// {partner's offset, gate bits}, or one uint16 per entry,
// (perm << 1) | (gate == 1), which is exact where every gate is 0 or 1
// (else the gate itself is read from device memory).
enum Tables { kWide = 1, kCompact = 2 };

__host__ __device__ inline size_t table_bytes(int n, int m, int tables) {
  const size_t entries = static_cast<size_t>(m) * n;
  return tables == kWide ? sizeof(int2) * entries : align16(2 * entries);
}

__host__ __device__ inline size_t smem_bytes(int n, int cols, int w_window,
                                             int m, int wire_bf16, int nbuf,
                                             int tables) {
  return image_bytes(n, cols, wire_bf16, nbuf) + weight_bytes(w_window, m) +
         table_bytes(n, m, tables);
}

// Load a thread's rows of one slab (zeros past N and past D).
template <typename StateT, int R>
__device__ __forceinline__ void load_slab(const StateT* __restrict__ x,
                                          float (&dst)[R][2], int g,
                                          int groups, int n, long long d,
                                          long long col, int vec) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = g + r * groups;
    dst[r][0] = 0.0f;
    dst[r][1] = 0.0f;
    if (i < n && col < d) {
      const StateT* src = x + static_cast<long long>(i) * d + col;
      if (vec && col + 1 < d) {
        const float2 v = StateIO<StateT>::load2(src);
        dst[r][0] = v.x;
        dst[r][1] = v.y;
      } else {
        dst[r][0] = StateIO<StateT>::load(src);
        if (col + 1 < d) dst[r][1] = StateIO<StateT>::load(src + 1);
      }
    }
  }
}

template <typename StateT, int R>
__device__ __forceinline__ void store_slab(StateT* __restrict__ out,
                                           const float (&src)[R][2], int g,
                                           int groups, int n, long long d,
                                           long long col, int vec) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = g + r * groups;
    if (i >= n || col >= d) continue;
    StateT* dst = out + static_cast<long long>(i) * d + col;
    if (vec && col + 1 < d) {
      StateIO<StateT>::store2(dst, src[r][0], src[r][1]);
    } else {
      StateIO<StateT>::store(dst, src[r][0]);
      if (col + 1 < d) StateIO<StateT>::store(dst + 1, src[r][1]);
    }
  }
}

// One CTA walks the slabs blockIdx.x, blockIdx.x + gridDim.x, ... (a
// persistent grid).
template <typename StateT, bool WIRE_BF16, bool DBUF, int R, int TABLES>
__global__ void __launch_bounds__(kMaxThreads, 1)
    perm_gossip_kernel(const StateT* __restrict__ x, StateT* __restrict__ out,
                       const float* __restrict__ weights,
                       const int* __restrict__ perms,
                       const float* __restrict__ gate, int n, long long d,
                       int m, int n_windows, int w_window, int cols, int nbuf,
                       int vec) {
  using WireT = typename Wire<WIRE_BF16>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lanes = cols / 2;                 // threads along a row
  const int lane = threadIdx.x % lanes;
  const int g = threadIdx.x / lanes;          // rows g, g + groups, ...
  const int groups = blockDim.x / lanes;
  const int lc = 2 * lane;                    // first column in the slab
  const int win_len = w_window * m;
  const long long n_slabs = (d + cols - 1) / cols;
  const size_t img_elems = static_cast<size_t>(n) * cols;
  WireT* img = reinterpret_cast<WireT*>(smem);
  float* wbuf = reinterpret_cast<float*>(
      smem + image_bytes(n, cols, WIRE_BF16 ? 1 : 0, nbuf));
  unsigned char* tab_base =
      reinterpret_cast<unsigned char*>(wbuf) + weight_bytes(w_window, m);
  const int2* tab_wide = reinterpret_cast<const int2*>(tab_base);
  const uint16_t* tab_compact = reinterpret_cast<const uint16_t*>(tab_base);

  long long slab = blockIdx.x;
  // this slab's state in flight first, then the tables and weights
  float xs[R][2];
  load_slab<StateT, R>(x, xs, g, groups, n, d, slab * cols + lc, vec);
  if (DBUF) {  // warm the pipeline: window 0 into slot 0
    for (int k = threadIdx.x; k < win_len; k += blockDim.x) {
      __pipeline_memcpy_async(wbuf + k, weights + k, sizeof(float));
    }
    __pipeline_commit();
  }
  // finite gates: a zero weight makes every coefficient of its matching
  // zero; binary gates (all 0 or 1): the compact table holds them exactly
  bool finite_gates = true;
  bool binary = true;
  for (int k = threadIdx.x; k < m * n; k += blockDim.x) {
    const float gk = gate[k];
    finite_gates = finite_gates && isfinite(gk);
    binary = binary && (gk == 0.0f || gk == 1.0f);
    if (TABLES == kWide) {  // the partner's offset in the image
      reinterpret_cast<int2*>(tab_base)[k] =
          make_int2(perms[k] * cols, __float_as_int(gk));
    } else {
      reinterpret_cast<uint16_t*>(tab_base)[k] = static_cast<uint16_t>(
          (perms[k] << 1) | (gk == 1.0f ? 1 : 0));
    }
  }
  finite_gates = __syncthreads_and(finite_gates);
  binary = __syncthreads_and(binary);

  int step = 0;
  for (; slab < n_slabs; slab += gridDim.x) {
    const long long col = slab * cols + lc;
    const long long next = slab + gridDim.x;
    for (int win = 0; win < n_windows; ++win) {
      const int slot = win & 1;
      const float* wcur = wbuf + slot * win_len;
      if (DBUF) {
        __pipeline_wait_prior(0);  // this window landed
      } else if (n_windows > 1 || slab == blockIdx.x) {
        // slot was last read in window win-2 (or in the previous slab,
        // which ended with a barrier); a single window stays resident
        float* dst = wbuf + slot * win_len;
        const float* src = weights + static_cast<size_t>(win) * win_len;
        for (int k = threadIdx.x; k < win_len; k += blockDim.x) {
          dst[k] = src[k];
        }
      }

      for (int s = 0; s < w_window; ++s, ++step) {
        WireT* im = img + (nbuf == 2 ? (step & 1) : 0) * img_elems;
        const WireT* im_lc = im + lc;
        float xw[R][2];
        bool tame = true;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = g + r * groups;
          xw[r][0] = Wire<WIRE_BF16>::round(xs[r][0]);
          xw[r][1] = Wire<WIRE_BF16>::round(xs[r][1]);
          if (i < n) {
            Wire<WIRE_BF16>::store2(im + static_cast<size_t>(i) * cols + lc,
                                    xw[r][0], xw[r][1]);
            tame = tame && fabsf(xw[r][0]) < kTame &&
                   fabsf(xw[r][1]) < kTame;
          }
        }
        // the image (and at a window's first step its weights) visible to
        // all; a buffer written here was last read two steps ago
        const bool skip = __syncthreads_and(tame);
        if (DBUF && s == 0 && win + 1 < n_windows) {
          // every thread is past window win-1, the other slot's last reader
          float* wnext = wbuf + (slot ^ 1) * win_len;
          const float* src =
              weights + static_cast<size_t>(win + 1) * win_len;
          for (int k = threadIdx.x; k < win_len; k += blockDim.x) {
            __pipeline_memcpy_async(wnext + k, src + k, sizeof(float));
          }
          __pipeline_commit();
        }

        float acc[R][2];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.0f;
        const float* w = wcur + s * m;
        for (int j = 0; j < m; ++j) {
          const float wj = w[j];
          if (skip && finite_gates && wj == 0.0f) continue;  // CTA-uniform
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int i = g + r * groups;
            if (i >= n) continue;
            const int k = j * n + i;
            int off;  // the partner's offset in the image
            float gt;
            if (TABLES == kWide) {
              const int2 e = tab_wide[k];
              off = e.x;
              gt = __int_as_float(e.y);
            } else {
              const int e = tab_compact[k];
              off = (e >> 1) * cols;
              gt = binary ? static_cast<float>(e & 1) : __ldg(gate + k);
            }
            const float coef = __fmul_rn(wj, gt);
            if (skip && coef == 0.0f) continue;  // uniform across the row
            const float2 pv = Wire<WIRE_BF16>::load2(im_lc + off);
            acc[r][0] = __fadd_rn(
                acc[r][0], __fmul_rn(coef, __fsub_rn(pv.x, xw[r][0])));
            acc[r][1] = __fadd_rn(
                acc[r][1], __fmul_rn(coef, __fsub_rn(pv.y, xw[r][1])));
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          xs[r][0] = StateIO<StateT>::round(__fadd_rn(xs[r][0], acc[r][0]));
          xs[r][1] = StateIO<StateT>::round(__fadd_rn(xs[r][1], acc[r][1]));
        }
        if (nbuf == 1) __syncthreads();  // the one buffer is read
      }
    }

    store_slab<StateT, R>(out, xs, g, groups, n, d, col, vec);
    if (next < n_slabs) {
      if (n_windows > 1) {
        __syncthreads();  // every weight slot is read: window 0 comes back
        if (DBUF) {
          for (int k = threadIdx.x; k < win_len; k += blockDim.x) {
            __pipeline_memcpy_async(wbuf + k, weights + k, sizeof(float));
          }
          __pipeline_commit();
        }
      }
      load_slab<StateT, R>(x, xs, g, groups, n, d, next * cols + lc, vec);
    }
  }
}

// Each instantiation's address; launched through cudaLaunchKernel with its
// arguments in order, whatever its state type.
using KernelFn = const void*;

template <typename StateT, bool WIRE_BF16, bool DBUF, int R>
KernelFn pick_tables(int tables) {
  switch (tables) {
    case kWide: return reinterpret_cast<KernelFn>(
        perm_gossip_kernel<StateT, WIRE_BF16, DBUF, R, kWide>);
    case kCompact: return reinterpret_cast<KernelFn>(
        perm_gossip_kernel<StateT, WIRE_BF16, DBUF, R, kCompact>);
    default: return nullptr;
  }
}

template <typename StateT, bool WIRE_BF16, bool DBUF>
KernelFn pick_rows(int rows, int tables) {
  switch (rows) {
    case 4: return pick_tables<StateT, WIRE_BF16, DBUF, 4>(tables);
    case 8: return pick_tables<StateT, WIRE_BF16, DBUF, 8>(tables);
    default: return nullptr;
  }
}

template <typename StateT>
KernelFn pick_wire(int wire_bf16, int dbuf, int rows, int tables) {
  if (wire_bf16) {
    return dbuf ? pick_rows<StateT, true, true>(rows, tables)
                : pick_rows<StateT, true, false>(rows, tables);
  }
  return dbuf ? pick_rows<StateT, false, true>(rows, tables)
              : pick_rows<StateT, false, false>(rows, tables);
}

KernelFn pick_kernel(int state_dtype, int wire_dtype, int dbuf, int rows,
                     int tables) {
  return state_dtype == 0
             ? pick_wire<float>(wire_dtype, dbuf, rows, tables)
             : pick_wire<__nv_bfloat16>(wire_dtype, dbuf, rows, tables);
}

bool takes(int n, int cols, int rows, int threads, int w_window, int m,
           int state_dtype, int wire_dtype, int nbuf, int tables) {
  const int lanes = cols / 2;
  return n >= 1 && m >= 1 && w_window >= 1 && cols >= 2 && cols % 2 == 0 &&
         threads >= lanes && threads <= kMaxThreads && threads % lanes == 0 &&
         static_cast<long long>(threads / lanes) * rows >= n &&
         (rows == 4 || rows == 8) &&
         (nbuf == 1 || nbuf == 2) &&
         (state_dtype == 0 || state_dtype == 1) &&
         (wire_dtype == 0 || wire_dtype == 1) &&
         (tables == kWide || (tables == kCompact && n <= 32768)) &&
         smem_bytes(n, cols, w_window, m, wire_dtype, nbuf, tables) <=
             kMaxSharedBytes;
}

// A launch configuration's grid, once the occupancy API has been asked.
struct Grid {
  KernelFn kernel;
  int device;
  int threads;
  size_t smem;
  long long ctas;
};

std::mutex grid_mutex;
std::vector<Grid> grids;

// CTAs of this shape resident on the whole card at once (at most
// kMaxCtasPerSm per SM), or a negative CUDA error code; kept per
// configuration.  The kernel's shared-memory attribute is only ever
// raised, to the most any kept configuration of it needs, so that every
// kept configuration stays launchable.
long long card_ctas(KernelFn kernel, int threads, size_t smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  std::lock_guard<std::mutex> lock(grid_mutex);
  size_t allowed = 0;  // the attribute as this kernel's kept grids set it
  for (const Grid& g : grids) {
    if (g.kernel != kernel || g.device != device) continue;
    if (g.threads == threads && g.smem == smem) return g.ctas;
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
                                                        threads, smem);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const long long ctas = static_cast<long long>(sms) *
                         (blocks < kMaxCtasPerSm ? blocks : kMaxCtasPerSm);
  grids.push_back({kernel, device, threads, smem, ctas});
  return ctas;
}

// ------------------------------------------------- the per-step path
//
// Where no slab shape fits a CTA (N above 8192, or too many matchings for
// the tables beside the image), the state stays in device memory: one
// launch per step, ping-ponging two state buffers, each thread one column
// pair of one row at a time, gathering its partners' pairs straight from
// device memory (every lane of a CTA reads the same partner row, so the
// reads are coalesced).  The arithmetic is the slab kernel's, operation
// for operation: the wire image, the coefficient w_j * gate[j,i] once per
// row, f32 accumulation in j order, unfused.  Zero terms are skipped
// exactly as there, where every value of the step's wire image is below
// 2^127: a flag per step, cleared by any CTA that writes (or, for step 0,
// scans) a value at or above it.

constexpr int kStepThreads = 256;
constexpr int kStepCols = 2 * kStepThreads;  // a column pair a thread
constexpr int kMaxGridY = 65535;

template <typename StateT, bool WIRE_BF16>
__global__ void __launch_bounds__(kStepThreads)
    tame_scan(const StateT* __restrict__ x, long long total,
              int* __restrict__ tame) {
  bool ok = true;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    ok = ok && fabsf(Wire<WIRE_BF16>::round(StateIO<StateT>::load(x + e))) <
                   kTame;
  }
  if (!__syncthreads_and(ok) && threadIdx.x == 0) atomicAnd(tame, 0);
}

template <typename StateT, bool WIRE_BF16>
__global__ void __launch_bounds__(kStepThreads)
    perm_step_kernel(const StateT* __restrict__ src, StateT* __restrict__ dst,
                     const float* __restrict__ w,
                     const int* __restrict__ perms,
                     const float* __restrict__ gate, int n, long long d,
                     int m, const int* __restrict__ tame_in,
                     int* __restrict__ tame_out, int vec) {
  const bool skip = *tame_in != 0;
  const long long col =
      static_cast<long long>(blockIdx.x) * kStepCols + 2 * threadIdx.x;
  bool ok = true;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    float xs[1][2];
    load_slab<StateT, 1>(src, xs, i, 0, n, d, col, vec);
    const float xw0 = Wire<WIRE_BF16>::round(xs[0][0]);
    const float xw1 = Wire<WIRE_BF16>::round(xs[0][1]);
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int j = 0; j < m; ++j) {
      const int k = j * n + i;
      const float coef = __fmul_rn(w[j], gate[k]);
      if (skip && coef == 0.0f) continue;  // uniform across the CTA
      float pv[1][2];
      load_slab<StateT, 1>(src, pv, perms[k], 0, n, d, col, vec);
      acc0 = __fadd_rn(acc0, __fmul_rn(coef, __fsub_rn(
                                 Wire<WIRE_BF16>::round(pv[0][0]), xw0)));
      acc1 = __fadd_rn(acc1, __fmul_rn(coef, __fsub_rn(
                                 Wire<WIRE_BF16>::round(pv[0][1]), xw1)));
    }
    xs[0][0] = StateIO<StateT>::round(__fadd_rn(xs[0][0], acc0));
    xs[0][1] = StateIO<StateT>::round(__fadd_rn(xs[0][1], acc1));
    store_slab<StateT, 1>(dst, xs, i, 0, n, d, col, vec);
    ok = ok && (col >= d || fabsf(Wire<WIRE_BF16>::round(xs[0][0])) < kTame)
            && (col + 1 >= d ||
                fabsf(Wire<WIRE_BF16>::round(xs[0][1])) < kTame);
  }
  if (tame_out != nullptr && !__syncthreads_and(ok) && threadIdx.x == 0) {
    atomicAnd(tame_out, 0);
  }
}

size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

// Scratch: one tameness flag per step and one for the output, then the
// states between steps (two where t >= 3, one where t == 2).
size_t step_scratch_bytes(int n, long long d, int t_steps, int state_dtype) {
  const size_t state =
      align256((state_dtype == 0 ? 4 : 2) * static_cast<size_t>(n) * d);
  const size_t bufs = t_steps >= 3 ? 2 : (t_steps == 2 ? 1 : 0);
  return align256(sizeof(int) * (static_cast<size_t>(t_steps) + 1)) +
         bufs * state;
}

template <typename StateT, bool WIRE_BF16>
cudaError_t run_steps(const void* x, void* out, const float* weights,
                      const int* perms, const float* gate,
                      unsigned char* scratch, int n, long long d, int t_steps,
                      int m, int vec, cudaStream_t s) {
  int* tame = reinterpret_cast<int*>(scratch);
  const size_t flags =
      align256(sizeof(int) * (static_cast<size_t>(t_steps) + 1));
  const size_t state = align256(sizeof(StateT) * static_cast<size_t>(n) * d);
  StateT* bufs[2] = {reinterpret_cast<StateT*>(scratch + flags),
                     reinterpret_cast<StateT*>(scratch + flags + state)};
  // every flag nonzero ("tame") until a CTA clears it
  cudaError_t err = cudaMemsetAsync(tame, 1, flags, s);
  if (err != cudaSuccess) return err;
  const StateT* src = static_cast<const StateT*>(x);
  const long long total = static_cast<long long>(n) * d;
  const long long scan_blocks = (total + kStepThreads - 1) / kStepThreads;
  tame_scan<StateT, WIRE_BF16>
      <<<static_cast<unsigned>(scan_blocks < 4096 ? scan_blocks : 4096),
         kStepThreads, 0, s>>>(src, total, tame);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((d + kStepCols - 1) / kStepCols),
                  n < kMaxGridY ? n : kMaxGridY);
  for (int t = 0; t < t_steps; ++t) {
    const bool last = t + 1 == t_steps;
    StateT* dst = last ? static_cast<StateT*>(out) : bufs[t % 2];
    perm_step_kernel<StateT, WIRE_BF16><<<grid, kStepThreads, 0, s>>>(
        src, dst, weights + static_cast<size_t>(t) * m, perms, gate, n, d, m,
        tame + t, last ? nullptr : tame + t + 1, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Device memory the per-step path needs as `scratch`, in bytes.
long long perm_gossip_step_scratch_bytes(int n, long long d, int t_steps,
                                         int state_dtype) {
  if (n < 1 || d < 1 || t_steps < 1) return -1;
  return static_cast<long long>(step_scratch_bytes(n, d, t_steps,
                                                   state_dtype));
}

// The per-step path: t_padded launches of one step each on x[n, d] into
// out[n, d], the state between steps in `scratch`
// (perm_gossip_step_scratch_bytes).  Any n and m.  Returns
// cudaGetLastError() after the launches (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments it does not take.
int perm_gossip_step_launch(const void* x, void* out, const void* weights,
                            const void* perms, const void* gate,
                            void* scratch, int n, long long d, int t_padded,
                            int m, int state_dtype, int wire_dtype,
                            void* stream) {
  if (n < 1 || d < 1 || t_padded < 1 || m < 1 || scratch == nullptr ||
      (state_dtype != 0 && state_dtype != 1) ||
      (wire_dtype != 0 && wire_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t pair = state_dtype == 0 ? 8 : 4;
  int vec = d % 2 == 0 && reinterpret_cast<uintptr_t>(x) % pair == 0 &&
            reinterpret_cast<uintptr_t>(out) % pair == 0;
  auto* buf = static_cast<unsigned char*>(scratch);
  const float* w = static_cast<const float*>(weights);
  const int* p = static_cast<const int*>(perms);
  const float* g = static_cast<const float*>(gate);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (state_dtype == 0) {
    err = wire_dtype ? run_steps<float, true>(x, out, w, p, g, buf, n, d,
                                              t_padded, m, vec, s)
                     : run_steps<float, false>(x, out, w, p, g, buf, n, d,
                                               t_padded, m, vec, s);
  } else {
    err = wire_dtype
              ? run_steps<__nv_bfloat16, true>(x, out, w, p, g, buf, n, d,
                                               t_padded, m, vec, s)
              : run_steps<__nv_bfloat16, false>(x, out, w, p, g, buf, n, d,
                                                t_padded, m, vec, s);
  }
  return static_cast<int>(err);
}


// Shared memory one CTA needs, in bytes (the wrapper picks the shape).
long long perm_gossip_smem_bytes(int n, int cols, int w_window, int m,
                                 int wire_bf16, int nbuf, int tables) {
  return static_cast<long long>(
      smem_bytes(n, cols, w_window, m, wire_bf16, nbuf, tables));
}

long long perm_gossip_smem_limit() { return kMaxSharedBytes; }

long long perm_gossip_max_threads() { return kMaxThreads; }

// Launch T = t_padded steps on x[n, d] into out[n, d] on `stream`: CTAs of
// `threads` threads walk the slabs of `cols` columns, each thread holding
// up to `rows` rows of two columns; at most kMaxCtasPerSm CTAs per SM
// (fewer where the occupancy API says so), no more CTAs than slabs.
// state_dtype / wire_dtype: 0 = float32, 1 = bfloat16 (wire 0 = no cast).
// nbuf: wire-image buffers (1 or 2); tables: 1 int2, 2 uint16 per entry
// (n <= 32768).  Returns
// cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int perm_gossip_launch(const void* x, void* out, const void* weights,
                       const void* perms, const void* gate, int n,
                       long long d, int t_padded, int m, int w_window,
                       int cols, int rows, int threads, int state_dtype,
                       int wire_dtype, int dbuf, int nbuf, int tables,
                       void* stream) {
  if (d < 1 || t_padded < 1 || w_window < 1 || t_padded % w_window != 0 ||
      !takes(n, cols, rows, threads, w_window, m, state_dtype, wire_dtype,
             nbuf, tables)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KernelFn kernel = pick_kernel(state_dtype, wire_dtype, dbuf, rows, tables);
  const size_t smem =
      smem_bytes(n, cols, w_window, m, wire_dtype, nbuf, tables);
  const long long fill = card_ctas(kernel, threads, smem);
  if (fill < 0) return static_cast<int>(-fill);
  if (fill == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long n_slabs = (d + cols - 1) / cols;
  const unsigned blocks =
      static_cast<unsigned>(n_slabs < fill ? n_slabs : fill);
  // pairs move as one access where every row's pair is aligned: even D and
  // base pointers aligned to a pair
  const size_t pair = state_dtype == 0 ? 8 : 4;
  int vec = d % 2 == 0 && reinterpret_cast<uintptr_t>(x) % pair == 0 &&
            reinterpret_cast<uintptr_t>(out) % pair == 0;
  const float* w = static_cast<const float*>(weights);
  const int* p = static_cast<const int*>(perms);
  const float* g = static_cast<const float*>(gate);
  int n_windows = t_padded / w_window;
  void* args[] = {&x, &out, &w, &p, &g, &n, &d, &m, &n_windows,
                  &w_window, &cols, &nbuf, &vec};
  cudaError_t err = cudaLaunchKernel(kernel, dim3(blocks), dim3(threads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* perm_gossip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
