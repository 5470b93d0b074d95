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
//
// The band path.  Where no slab shape fits a CTA (N above 8192, or more
// matchings than the tables beside the image allow), and for one step from
// 4096 workers, where 4- and 2-column slabs serve device memory poorly
// (perm_gossip.py's _launch_shape), the state stays in device memory and
// the chain runs in column bands [N, cols]: the gathers move rows, never
// columns, so a band's T-step chain needs no other band.  One persistent
// grid, launched cooperatively so that its CTAs may wait for each other,
// walks the bands one after another, with a grid barrier (an arrival
// counter in scratch) between a band's steps.  cols keeps the band's two
// [N, cols] buffers well inside the 50 MB L2, so a step's gathers are L2
// hits and device memory sees the state read once and written once for
// the whole chain.  At T = 1 there is no barrier: the
// one step reads x and writes out.  From T = 2 a band is first copied from
// x into a buffer (one barrier), and the steps ping-pong between the two
// buffers with one barrier each, the last writing out: x's rows lie D
// apart, so gathering from x touches a page a row, and the copy made the
// 4096-worker ER graph's four steps 10 % faster (PERF.md).  Each warp
// takes rows of the band (rows fastest); each lane moves 16 bytes (four
// f32 or eight bf16 columns) where every row's start allows it, else 8 or
// 4, else element by element.  Per window of 32 matchings the warp reads
// its rows' [N, M] table entries {partner, gate bits} (one coalesced load
// a row; the wrapper builds the table), forms the coefficients, and a
// ballot gives each row its active terms; each lane then issues 32 bytes'
// worth of partner loads (8 f32 or 4 bf16 of 16 bytes) before it sums
// them in j order, the slab kernel's arithmetic operation for operation.
// Zero terms are skipped as above, decided per band and step: the copy of
// x, and the writers of each step's output, stamp the grid's flag where a
// value of the wire image is wild, and the next step reads it after the
// barrier.  At T = 1 the step skips optimistically while each row checks
// its own values; the last CTA to finish a band whose x was wild computes
// the band again without skips.  What bounds it: the gathers' L2 reads,
// (2 + a) band rows a row and step (a: the row's active partnered terms),
// which an H100 served at 2.5-3.9 TB/s, not device memory: 4.3-12x the
// byte bound (PERF.md).

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

// ------------------------------------------------- the band path
//
// Column bands of the state held in L2 for a whole chain (header comment,
// "The band path").

constexpr int kBandThreads = 256;
// The grid's flag words (a 128-byte line, apart from the bands' words): the
// barrier's arrival counter, then the two stamp slots of "a value of the
// step's input was wild" and the two of "a value of the step's output was
// wild"
constexpr int kGridWords = 32;
constexpr int kArrive = 0, kSrcWild = 2, kDstWild = 4;

// 16 bytes of a row, as raw bits: V = 16 / sizeof(StateT) columns a lane.
struct Raw16 {
  unsigned w[4];
};

template <typename T>
struct Lane;

template <>
struct Lane<float> {
  static constexpr int V = 4;
  __device__ static float get(const Raw16& r, int e) {
    return __uint_as_float(r.w[e]);
  }
  // v is a value of the state type already (StateIO::round)
  __device__ static void put(Raw16& r, int e, float v) {
    r.w[e] = __float_as_uint(v);
  }
  __device__ static unsigned bits(const float* p) {
    return __ldcg(reinterpret_cast<const unsigned*>(p));
  }
  __device__ static void set_bits(float* p, unsigned long long v) {
    __stcg(reinterpret_cast<unsigned*>(p), static_cast<unsigned>(v));
  }
};

template <>
struct Lane<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static float get(const Raw16& r, int e) {
    return __uint_as_float(((r.w[e >> 1] >> ((e & 1) * 16)) & 0xffffu)
                           << 16);
  }
  __device__ static void put(Raw16& r, int e, float v) {
    const unsigned bits = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    const int sh = (e & 1) * 16;
    r.w[e >> 1] = (r.w[e >> 1] & ~(0xffffu << sh)) | (bits << sh);
  }
  __device__ static unsigned bits(const __nv_bfloat16* p) {
    return __ldcg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void set_bits(__nv_bfloat16* p, unsigned long long v) {
    __stcg(reinterpret_cast<unsigned short*>(p),
           static_cast<unsigned short>(v));
  }
};

// A lane's V columns at p: `valid` of them exist (a ragged band's edge),
// moved in pieces of `piece` bytes (16, 8 or 4; else element by element,
// little-endian into the 16 bytes).
// Loads go to L2 (.cg): the band buffers are written by other SMs within
// the launch, so L1 could hold a stale copy, and partner rows would only
// evict the tables from L1.
template <typename StateT>
__device__ __forceinline__ Raw16 load16(const StateT* p, int valid,
                                        int piece) {
  constexpr int V = Lane<StateT>::V;
  Raw16 r = {{0u, 0u, 0u, 0u}};
  if (valid >= V && piece == 16) {
    const uint4 q = __ldcg(reinterpret_cast<const uint4*>(p));
    r.w[0] = q.x; r.w[1] = q.y; r.w[2] = q.z; r.w[3] = q.w;
    return r;
  }
  if (valid >= V && piece == 8) {
    const uint2* s = reinterpret_cast<const uint2*>(p);
    const uint2 a = __ldcg(s), b = __ldcg(s + 1);
    r.w[0] = a.x; r.w[1] = a.y; r.w[2] = b.x; r.w[3] = b.y;
    return r;
  }
  if (valid >= V && piece == 4) {
    const unsigned* s = reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = __ldcg(s + k);
    return r;
  }
  // element by element (a ragged band's edge, or 2-byte pieces): a loop,
  // so that this rare path stays a branch and holds no registers of the
  // vector paths' loads in flight
  constexpr int kBits = 8 * sizeof(StateT);
  unsigned long long lo = 0, hi = 0;
#pragma unroll 1
  for (int e = 0; e < (valid < V ? valid : V); ++e) {
    const unsigned long long v = Lane<StateT>::bits(p + e);
    if (e * kBits < 64) {
      lo |= v << (e * kBits);
    } else {
      hi |= v << (e * kBits - 64);
    }
  }
  r.w[0] = static_cast<unsigned>(lo);
  r.w[1] = static_cast<unsigned>(lo >> 32);
  r.w[2] = static_cast<unsigned>(hi);
  r.w[3] = static_cast<unsigned>(hi >> 32);
  return r;
}

template <typename StateT>
__device__ __forceinline__ void store16(StateT* p, const Raw16& r, int valid,
                                        int piece) {
  constexpr int V = Lane<StateT>::V;
  if (valid >= V && piece == 16) {
    __stcg(reinterpret_cast<uint4*>(p),
           make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]));
    return;
  }
  if (valid >= V && piece == 8) {
    uint2* s = reinterpret_cast<uint2*>(p);
    __stcg(s, make_uint2(r.w[0], r.w[1]));
    __stcg(s + 1, make_uint2(r.w[2], r.w[3]));
    return;
  }
  if (valid >= V && piece == 4) {
    unsigned* s = reinterpret_cast<unsigned*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) __stcg(s + k, r.w[k]);
    return;
  }
  constexpr int kBits = 8 * sizeof(StateT);
  const unsigned long long lo =
      r.w[0] | static_cast<unsigned long long>(r.w[1]) << 32;
  const unsigned long long hi =
      r.w[2] | static_cast<unsigned long long>(r.w[3]) << 32;
#pragma unroll 1
  for (int e = 0; e < (valid < V ? valid : V); ++e) {
    Lane<StateT>::set_bits(p + e, e * kBits < 64 ? lo >> (e * kBits)
                                                 : hi >> (e * kBits - 64));
  }
}

// How a band's rows map onto warps: a row's cols / V lanes are `lanes`
// lanes of one warp (rw = 32 / lanes rows a warp) when they fit a warp,
// else `segs` warps of 32 lanes.  A unit (one warp's share of a step) is
// rw rows of one segment; units go rows-fastest.
struct BandMap {
  int lanes, rw, segs, rgroups;
};

__device__ __forceinline__ unsigned ld_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void st_volatile(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// One step on one band for the units u = wr, wr + wq, ... of its rows
// (the loop is uniform across the warp): src rows at src + i * sstride,
// dst rows at dst + i * dstride, `width` columns.  Per window of 32
// matchings, lane l reads entry j0 + l of each of the warp's rows from the
// [n, m] table, forms its coefficient, and keeps it in the warp's window
// `win` ([rw][32] in shared memory); a ballot gives each row the set of
// its active terms, and each lane then gathers them 32 bytes' worth of
// columns at a time (8 f32 loads of 16 bytes, 4 bf16), in j order, loads
// first.  The arithmetic of the slab kernel, operation for operation.
// skip: zero-coefficient terms may be skipped (the input's wire image is
// tame).  src_wild / dst_wild: some value of the input's / output's wire
// image is at or above 2^127 (or not finite), where asked.
template <typename StateT, bool WIRE_BF16>
__device__ __forceinline__ void band_step(
    const StateT* src, long long sstride, int spiece, StateT* dst,
    long long dstride, int dpiece, const float* __restrict__ w,
    const int2* __restrict__ tab, int2* win, int n, int m, int width,
    const BandMap& map, int wr, int wq, bool skip, bool check_src,
    bool check_dst, bool& src_wild, bool& dst_wild) {
  constexpr int V = Lane<StateT>::V;
  constexpr int kBatch = 32 / V;  // partner loads in flight a lane
  // a bf16 state is its own bf16 wire image
  using W = Wire<WIRE_BF16 && sizeof(StateT) == 4>;
  const int lane = threadIdx.x & 31;
  const int rsub = lane / map.lanes;
  const int lsub = lane % map.lanes;
  const int units = map.segs * map.rgroups;
  for (int u = wr; u < units; u += wq) {
    const int seg = u / map.rgroups;
    const int i0 = (u - seg * map.rgroups) * map.rw;  // the warp's first row
    const int i = i0 + rsub;
    const int col = (seg * map.lanes + lsub) * V;
    // lanes past N or past the band's edge move nothing
    const int valid = i < n ? width - col : 0;
    Raw16 own = {{0u, 0u, 0u, 0u}};
    if (valid > 0) own = load16<StateT>(src + i * sstride + col, valid, spiece);
    float xs[V], xw[V], acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      xs[e] = Lane<StateT>::get(own, e);
      xw[e] = W::round(xs[e]);
      acc[e] = 0.0f;
      if (check_src && e < valid && !(fabsf(xw[e]) < kTame)) src_wild = true;
    }
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const float wj = j < m ? __ldg(w + j) : 0.0f;
      unsigned mine = 0;
      for (int r = 0; r < map.rw; ++r) {
        const int ir = i0 + r;
        int2 e = make_int2(0, 0);
        bool act = false;
        if (ir < n && j < m) {
          e = __ldg(tab + static_cast<size_t>(ir) * m + j);
          const float coef = __fmul_rn(wj, __int_as_float(e.y));
          act = !skip || coef != 0.0f;
          e.y = __float_as_int(coef);
        }
        win[r * 32 + lane] = e;
        const unsigned mask = __ballot_sync(0xffffffffu, act);
        if (r == rsub) mine = mask;
      }
      __syncwarp();
      if (valid <= 0) mine = 0;
      while (__any_sync(0xffffffffu, mine != 0u)) {
        int jk[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          jk[k] = mine != 0u ? __ffs(mine) - 1 : -1;
          mine &= mine - 1;
        }
        float coef[kBatch];
        Raw16 pv[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (jk[k] >= 0) {
            const int2 e = win[rsub * 32 + jk[k]];
            coef[k] = __int_as_float(e.y);
            pv[k] = load16<StateT>(src + e.x * sstride + col, valid, spiece);
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (jk[k] < 0) continue;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc[e] = __fadd_rn(
                acc[e],
                __fmul_rn(coef[k],
                          __fsub_rn(W::round(
                                        Lane<StateT>::get(pv[k], e)),
                                    xw[e])));
          }
        }
      }
      __syncwarp();  // the window is read before the next one lands
    }
    if (valid <= 0) continue;
    Raw16 res = {{0u, 0u, 0u, 0u}};
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float v = StateIO<StateT>::round(__fadd_rn(xs[e], acc[e]));
      Lane<StateT>::put(res, e, v);
      if (check_dst && e < valid &&
          !(fabsf(W::round(v)) < kTame)) {
        dst_wild = true;
      }
    }
    store16<StateT>(dst + i * dstride + col, res, valid, dpiece);
  }
}

// Copy this warp's units of x's band (rows at x + i * d) into the
// contiguous band buffer `buf`; wild: some value's wire image is at or
// above 2^127 (or not finite).
template <typename StateT, bool WIRE_BF16>
__device__ __forceinline__ void band_stage(const StateT* x, long long d,
                                           int piece, StateT* buf, int cols,
                                           int n, int width,
                                           const BandMap& map, int wr, int wq,
                                           bool& wild) {
  constexpr int V = Lane<StateT>::V;
  using W = Wire<WIRE_BF16 && sizeof(StateT) == 4>;
  const int lane = threadIdx.x & 31;
  const int rsub = lane / map.lanes;
  const int lsub = lane % map.lanes;
  const int units = map.segs * map.rgroups;
  for (int u = wr; u < units; u += wq) {
    const int seg = u / map.rgroups;
    const int i = (u - seg * map.rgroups) * map.rw + rsub;
    const int col = (seg * map.lanes + lsub) * V;
    const int valid = i < n ? width - col : 0;
    if (valid <= 0) continue;
    const Raw16 v = load16<StateT>(x + i * d + col, valid, piece);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (e < valid && !(fabsf(W::round(Lane<StateT>::get(v, e))) < kTame)) {
        wild = true;
      }
    }
    store16<StateT>(buf + static_cast<size_t>(i) * cols + col, v, valid, 16);
  }
}

// The grid's barrier number `epoch` (0, 1, ...): it completes when all
// `ctas` CTAs of the grid have arrived, i.e. the arrival counter reaches
// (epoch + 1) * ctas (it only grows, so it needs no reset; compared
// modulo 2^32).  Returns, to every thread, bit 0: the input stamp of this
// epoch was set, bit 1: the output stamp was.  A stamp slot is written in
// epoch e (value e + 1) and read just after barrier e; the next write to
// the slot comes in epoch e + 2, after barrier e + 1, which no CTA passes
// before every CTA has read it.
__device__ __forceinline__ unsigned grid_barrier(unsigned* gf,
                                                  unsigned epoch,
                                                  unsigned ctas) {
  __shared__ unsigned seen;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(gf + kArrive, 1u);
    const unsigned target = (epoch + 1) * ctas;
    while (static_cast<int>(ld_volatile(gf + kArrive) - target) < 0) {
    }
    __threadfence();
    const int s = epoch & 1;
    seen = (ld_volatile(gf + kSrcWild + s) == epoch + 1 ? 1u : 0u) |
           (ld_volatile(gf + kDstWild + s) == epoch + 1 ? 2u : 0u);
  }
  __syncthreads();
  return seen;
}

// A CTA has finished its units of a band (T = 1): count it in; true, to
// every thread, if it is the last CTA to finish the band and the
// band's input was wild (then it recomputes the band without skips).
__device__ __forceinline__ bool band_done(unsigned* count,
                                          const unsigned* wild,
                                          unsigned ctas) {
  __shared__ unsigned redo;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(count, 1u) == ctas - 1;
    __threadfence();
    redo = last && ld_volatile(wild) != 0u ? 1u : 0u;
  }
  __syncthreads();
  return redo != 0u;
}

// A persistent, cooperatively launched grid that walks the bands in order.
// x and out: [n, d]; tab: [n, m] int2 {partner, gate bits}; bufs: two
// [n, cols] buffers; flags: kGridWords, then a counter and a wild flag a
// band (T = 1), all zero at launch.
template <typename StateT, bool WIRE_BF16>
__global__ void __launch_bounds__(kBandThreads, 2)
    perm_band_kernel(const StateT* __restrict__ x, StateT* __restrict__ out,
                     const float* __restrict__ weights,
                     const int2* __restrict__ tab, StateT* bufs,
                     unsigned* flags, int n, long long d, int t_steps, int m,
                     int cols, int piece) {
  constexpr int V = Lane<StateT>::V;
  extern __shared__ __align__(16) unsigned char band_smem[];
  const unsigned ctas = gridDim.x;
  const int wpc = blockDim.x >> 5;
  const int wr = static_cast<int>(blockIdx.x) * wpc +
                 static_cast<int>(threadIdx.x >> 5);
  const int wq = static_cast<int>(ctas) * wpc;
  BandMap map;
  const int per_row = cols / V;
  map.lanes = per_row < 32 ? per_row : 32;
  map.rw = 32 / map.lanes;
  map.segs = per_row / map.lanes;
  map.rgroups = (n + map.rw - 1) / map.rw;
  int2* win = reinterpret_cast<int2*>(band_smem) +
              (threadIdx.x >> 5) * map.rw * 32;
  const long long n_bands = (d + cols - 1) / cols;
  unsigned* gf = flags;
  unsigned* band_count = flags + kGridWords;
  unsigned* band_wild = band_count + n_bands;
  StateT* const buf0 = bufs;
  StateT* const buf1 = buf0 + static_cast<size_t>(n) * cols;
  unsigned epoch = 0;  // the grid's barriers so far
  int p0 = 0;          // the buffer a band's copy of x goes to
  for (long long band = 0; band < n_bands; ++band) {
    const long long col0 = band * cols;
    const int width = static_cast<int>(
        d - col0 < cols ? d - col0 : static_cast<long long>(cols));
    const StateT* xb = x + col0;
    StateT* ob = out + col0;
    bool src_wild = false, dst_wild = false;
    if (t_steps == 1) {
      // no barrier: skip optimistically; the last CTA to finish a band
      // whose input was wild recomputes it without skips
      band_step<StateT, WIRE_BF16>(xb, d, piece, ob, d, piece, weights, tab,
                                   win, n, m, width, map, wr, wq, true, true,
                                   false, src_wild, dst_wild);
      if (src_wild) st_volatile(band_wild + band, 1u);
      if (band_done(band_count + band, band_wild + band, ctas)) {
        band_step<StateT, WIRE_BF16>(xb, d, piece, ob, d, piece, weights,
                                     tab, win, n, m, width, map,
                                     threadIdx.x >> 5, wpc, false, false,
                                     false, src_wild, dst_wild);
      }
      continue;
    }
    // x's band into buf[p0] first, its wildness stamped: every step then
    // gathers from a contiguous buffer (x's rows lie D apart, so its
    // gathers would touch a page a row) and knows whether it may skip
    band_stage<StateT, WIRE_BF16>(xb, d, piece, p0 ? buf1 : buf0, cols, n,
                                  width, map, wr, wq, src_wild);
    if (src_wild) st_volatile(gf + kSrcWild + (epoch & 1), epoch + 1);
    unsigned seen = grid_barrier(gf, epoch++, ctas);
    bool skip = !(seen & 1u);
    for (int t = 0; t < t_steps; ++t) {
      const bool last = t + 1 == t_steps;
      const StateT* src = (p0 + t) & 1 ? buf1 : buf0;
      StateT* dst = last ? ob : ((p0 + t + 1) & 1 ? buf1 : buf0);
      dst_wild = false;
      band_step<StateT, WIRE_BF16>(
          src, cols, 16, dst, last ? d : cols, last ? piece : 16,
          weights + static_cast<size_t>(t) * m, tab, win, n, m, width, map,
          wr, wq, skip, false, !last, src_wild, dst_wild);
      if (last) break;
      if (dst_wild) st_volatile(gf + kDstWild + (epoch & 1), epoch + 1);
      seen = grid_barrier(gf, epoch++, ctas);
      skip = !(seen & 2u);
    }
    // the next band stages into the buffer this band's last step did not
    // read
    p0 = (p0 + t_steps) & 1;
  }
}

size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

int band_lanes(int state_dtype) { return state_dtype == 0 ? 4 : 8; }

bool band_takes(int n, long long d, int t_steps, int m, int state_dtype,
                int wire_dtype, int cols) {
  const int v = band_lanes(state_dtype);
  const int per_row = cols / v;
  return n >= 1 && d >= 1 && t_steps >= 1 && m >= 1 &&
         (state_dtype == 0 || state_dtype == 1) &&
         (wire_dtype == 0 || wire_dtype == 1) && cols >= v &&
         cols % v == 0 && (per_row & (per_row - 1)) == 0;
}

// The flags' bytes: kGridWords, then two words a band.
size_t band_flag_bytes(long long d, int cols) {
  const long long n_bands = (d + cols - 1) / cols;
  return align256(sizeof(unsigned) *
                  (kGridWords + 2 * static_cast<size_t>(n_bands)));
}

// Scratch: the flags, then two [n, cols] band buffers where t_steps >= 2.
size_t band_scratch_bytes(int n, long long d, int t_steps, int state_dtype,
                          int cols) {
  const size_t bufs = t_steps >= 2 ? 2 * static_cast<size_t>(n) * cols *
                                         (state_dtype == 0 ? 4 : 2)
                                   : 0;
  return band_flag_bytes(d, cols) + bufs;
}

// Shared memory of a CTA of the band path: each warp's table window, 32
// entries for each of its rows.
size_t band_smem_bytes(int state_dtype, int cols) {
  const int per_row = cols / band_lanes(state_dtype);
  const int rw = per_row < 32 ? 32 / per_row : 1;
  return static_cast<size_t>(kBandThreads / 32) * rw * 32 * sizeof(int2);
}

KernelFn pick_band(int state_dtype, int wire_dtype) {
  if (state_dtype == 0) {
    return wire_dtype ? reinterpret_cast<KernelFn>(
                            perm_band_kernel<float, true>)
                      : reinterpret_cast<KernelFn>(
                            perm_band_kernel<float, false>);
  }
  return wire_dtype ? reinterpret_cast<KernelFn>(
                          perm_band_kernel<__nv_bfloat16, true>)
                    : reinterpret_cast<KernelFn>(
                          perm_band_kernel<__nv_bfloat16, false>);
}

// The widest piece (16, 8 or 4 bytes, else one element) that every row of
// x and out starts on.
int row_piece(long long d, size_t elem, const void* x, const void* out) {
  for (int p = 16; p >= 4; p /= 2) {
    if (static_cast<size_t>(p) >= elem && (d * elem) % p == 0 &&
        reinterpret_cast<uintptr_t>(x) % p == 0 &&
        reinterpret_cast<uintptr_t>(out) % p == 0) {
      return p;
    }
  }
  return static_cast<int>(elem);
}

}  // namespace

extern "C" {

// Device memory the band path needs as `scratch`, in bytes, or -1 for
// arguments it does not take.
long long perm_gossip_band_scratch_bytes(int n, long long d, int t_steps,
                                         int state_dtype, int cols) {
  if (!band_takes(n, d, t_steps, 1, state_dtype, 0, cols)) return -1;
  return static_cast<long long>(
      band_scratch_bytes(n, d, t_steps, state_dtype, cols));
}

// The band path: one cooperative launch of T = t_padded steps on x[n, d]
// into out[n, d], in bands of `cols` columns, with the band buffers and
// flags in `scratch`
// (perm_gossip_band_scratch_bytes).  table: [n, m] int2 {partner, gate
// bits}.  Any n and m.  Returns cudaGetLastError() after the launch (0 =
// cudaSuccess), the launch's error (a refused cooperative launch
// included), or cudaErrorInvalidValue for arguments it does not take.
int perm_gossip_band_launch(const void* x, void* out, const void* weights,
                            const void* table, void* scratch, int n,
                            long long d, int t_padded, int m,
                            int state_dtype, int wire_dtype, int cols,
                            void* stream) {
  if (scratch == nullptr || !band_takes(n, d, t_padded, m, state_dtype,
                                        wire_dtype, cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KernelFn kernel = pick_band(state_dtype, wire_dtype);
  const size_t smem = band_smem_bytes(state_dtype, cols);
  const long long fill = card_ctas(kernel, kBandThreads, smem);
  if (fill < 0) return static_cast<int>(-fill);
  if (fill == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t flag_bytes = band_flag_bytes(d, cols);
  cudaError_t err = cudaMemsetAsync(scratch, 0, flag_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t elem = state_dtype == 0 ? 4 : 2;
  int piece = row_piece(d, elem, x, out);
  auto* flags = static_cast<unsigned*>(scratch);
  void* bufs = static_cast<unsigned char*>(scratch) + flag_bytes;
  const float* w = static_cast<const float*>(weights);
  const int2* tab = static_cast<const int2*>(table);
  void* args[] = {&x, &out, &w, &tab, &bufs, &flags, &n, &d,
                  &t_padded, &m, &cols, &piece};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(fill)),
                                    dim3(kBandThreads), args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
