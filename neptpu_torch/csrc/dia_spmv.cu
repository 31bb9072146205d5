// Stacked-DIA fused multi-term SpMV for Hopper (sm_90a):
//
//     y[r] = sum_d sum_i data[i, d, r] * WT[i, r + off_d]
//
// with WT read as zero outside [0, n).  This is the fused compute_Mlincomb
// contraction y = sum_i A_i W[:, i] over a bank of m banded terms that share
// ndiag diagonal offsets.  It replaces the TPU Pallas kernel
// neptpu/ops/pallas_spmv.py:_dia_kernel / dia_lincomb_pallas_padded and, like
// it, takes the operand term-major: WT (m, n), the layout the scans hold
// their term weights in.  For a warp WT[i, r + off] is then 32 consecutive
// words, as data[i, d, r] is.
//
// Two regimes bound it, and the one body is shaped for both.
//
// * n ~ 1e4 (every scan step; the compulsory traffic is under 1.5 MB, 0.6 us
//   of the card's memory rate): latency and launch.  What the design does:
//   - the offsets ride in the kernel's parameter block (__grid_constant__,
//     up to 256 of them), so no load waits on a load of an offset;
//   - for the narrow banks of the paths (m 1-4, ndiag <= 16) m is a template
//     bound and the diagonals go in chunks with compile-time trip counts: all
//     bank and operand loads of a chunk are started before its first multiply
//     (a chunk is sized to about 64 registers of loads, so 5-9 diagonals are
//     one or two round trips to memory instead of m * ndiag dependent ones);
//   - a block is 128 threads at every size.  Measured on the H100 under
//     CUDA-graph replay, 64, 128 and 256 threads read within 0.1 us of one
//     another at n ~ 1e4 and within 1 % at n = 1e6: the gain at the small
//     sizes is loads in flight and offsets by value, not the grid, so the
//     block size is a constant and no launch parameter.
// * n ~ 1e6 (the SpMV headline): bytes, and for bfloat16 the load count (a thread
//   that loads 2 bytes at a time keeps half the bytes in flight: one row per
//   thread ran no faster in bfloat16 than in float).  What the design does:
//   a bfloat16 thread owns VEC = 8 consecutive rows (16 bytes of bank) and
//   reads bank and operand in packed words.  r + off is not aligned for every
//   offset, so the operand comes as the two aligned words that cover
//   [r + off, r + off + VEC) and the wanted elements are picked out of them;
//   the shift off mod VEC is the same for the whole grid, so picking is a
//   uniform branch, not a select per element.  Threads whose window crosses
//   an end of [0, n) load element by element under the bounds test.  Packed
//   rows need n to be a multiple of VEC (every bank row then starts aligned)
//   and 16-byte aligned operands; otherwise one row per thread.  float and
//   double stay at one row per thread: measured on the H100, 4 floats a
//   thread were 2 % slower than 1 at the headline shape (the 4-byte loads of
//   a warp already fill 128-byte lines), and 4 bfloat16 a thread 30 % slower
//   than 8, so those widths are not built.
//
// Every output row is summed in one fixed order (diagonals outer, terms
// inner, one fused multiply-add each), whatever VEC, the chunking or the
// number of operands, so the results do not depend on the launch shape and
// the pair kernel equals two single launches bit for bit.
//
// Every other bank (more than 16 offsets or more than 4 terms: a quartic PEP
// on a stencil, a 27-point stencil, a bank built with fmt="dia") takes the
// generic body, laid out for this card.  The m * ndiag (diagonal, term)
// streams of the bank fall into 8 fixed contiguous runs, each summed from
// zero and the runs added in order, so every row is summed in one fixed
// order whatever the launch shape: the pair equals two single launches bit
// for bit, and both regimes below give the same bits.
//   - Below n = 270336 (an n ~ 1e4 bank: latency) dia_generic_split_kernel:
//     a block of 8 warps owns a tile of 64 rows (128 bfloat16 in pairs) and
//     warp g computes run g for all of them, U streams of 2 rows in flight
//     before the first multiply, so every warp streams bank rows, no warp
//     walks all of them, and the bank still gives ~180 blocks.  The operand
//     is staged in shared memory once a tile, the way the TPU kernel stages
//     its VMEM window (pallas_spmv.py:76-123): the sorted offsets form
//     clusters (a gap of at most a tile joins two offsets), and each
//     cluster's window [r0 + lo, r0 + TILE + hi) of every term comes in by
//     cp.async, zero-filled outside [0, n) (bfloat16, which cp.async cannot
//     move alone, as aligned 4-byte pairs where n is even and the operand
//     4-byte aligned, else through registers).  A 27-point stencil on a
//     100^3 grid is three clusters of span 202, not one of span 20202.
//     Clusters are staged while the windows of a pair launch fit 48 KB; the
//     diagonals of the rest read the operand through L1 (__ldg).  The runs
//     meet in shared memory.  The plan is made once a bank on the host
//     (ops/dia_kernel.py: generic_plan).
//   - From there (bandwidth: blocks enough) dia_generic_rows_kernel: a block
//     of 128 threads owns 512 rows (256 of double), each thread walks all
//     runs for its own 4 row groups (2 of double or of bfloat16 pairs), U
//     streams in flight, the operand through
//     L1 (neighbouring diagonals share its lines; measured on the H100, the
//     staged windows' barrier and copies cost more than they saved here),
//     adding each run's sum as it ends.  Per stream a thread steps two
//     pointers and tests one bound, so the instructions a row stay few.
// Offsets and window positions ride by value up to 256 diagonals and come
// from device arrays beyond.
//
// The pair entry points apply one bank to two operands (the re and im channels
// of the complex-as-real scan) in ONE launch: each thread keeps two sets of
// accumulators and loads every bank word once for both.
//
// Layouts (all contiguous): data (m, ndiag, n), WT (m, n), y (n,); the pair
// takes WreT, WimT (m, n) and writes yre, yim (n,).  float and double
// accumulate in the data type.  The bf16 entry points are the TPU kernel's
// second dtype: __nv_bfloat16 bank and operands, float accumulator and
// result.  One difference from the TPU body: pallas_spmv.py:118 multiplies in
// bf16 (each product rounded to bf16) and widens to f32 only for the sum;
// here both factors are widened first, so each product is formed exactly in
// f32 and only the sum rounds.
//
// The kernels allocate nothing and do not synchronise; they are launched on
// the caller's stream, and the C entry points return cudaGetLastError().
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kMaxByValue = 256;  // offsets that fit the parameter block
constexpr int kMaxClusters = 32;  // staged operand windows of the generic body

// The generic body's staged windows: cluster c of a tile starting at row r0
// is the operand elements [r0 + start[c], r0 + start[c] + len[c]), held at
// [base[c], base[c] + len[c]) of each term's window of `window` elements.
struct Clusters {
  int count;
  int window;
  int start[kMaxClusters];
  int len[kMaxClusters];
  int base[kMaxClusters];
};

// What a launch needs of a bank; the caller fills it once per bank (it
// mirrors BankStruct of ops/dia_kernel.py).
struct DiaBank {
  const void* data;
  const int* offsets_dev;  // read when ndiag > kMaxByValue
  long long n;
  int m;
  int ndiag;
  int vec;  // rows per thread: 1, or the packed width of the data type
  int offsets[kMaxByValue];
  // the generic body's plan (ops/dia_kernel.py: generic_plan)
  const int* pos_dev;  // read when ndiag > kMaxByValue
  int split;           // 1: the split kernel (n ~ 1e4), 0: the rows kernel
  int rows;            // R: VEC-row groups a lane owns of a tile
  int gvec;            // VEC: consecutive rows a lane loads as one word
  Clusters clusters;
  // per diagonal: where row r0 + t of the operand of its cluster's window
  // sits (pos[d] + t), or -1: that diagonal reads the operand through L1
  int pos[kMaxByValue];
};

namespace {

constexpr int kNarrow = 16;       // widest bank of the templated body
constexpr int kMaxTerms = 4;      // most terms of the templated body
constexpr int kThreads = 128;     // threads per block, at every size

// The narrow body's offsets, in the parameter block.
template <int CAP>
struct ByValue {
  int v[CAP];
  __device__ __forceinline__ int operator[](int d) const { return v[d]; }
};

// The accumulator (and result) type of a data type, and the widening load.
template <typename T> struct Acc { using type = T; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return fma(a, b, c);
}

// VEC consecutive elements moved as one word of up to 16 bytes.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC > 16 ? 16 : sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

// Diagonals whose loads are in flight together: about 64 registers' worth.
template <typename T, int M, int VEC, int K>
struct Chunk {
  // a lone element fills a register whatever its size
  static constexpr int bytes =
      VEC == 1 && sizeof(T) < 4 ? 4 : static_cast<int>(sizeof(T));
  static constexpr int words =
      (M * VEC * bytes * (1 + (VEC > 1 ? 2 : 1) * K) + 3) / 4;
  static constexpr int fit = 64 / words;
  static constexpr int diagonals =
      fit < 1 ? 1 : (fit > kNarrow ? kNarrow : fit);
};

// acc[k][v] += a[i][v] * W_k[i][v + S] over the terms, the operand elements
// v + S picked out of the aligned words lo (elements 0..VEC-1) and hi.
template <int S, typename T, int M, int VEC, int K>
__device__ __forceinline__ void accumulate(
    typename Acc<T>::type (&acc)[K][VEC], const Pack<T, VEC> (&a)[M],
    const Pack<T, VEC> (&lo)[K][M], const Pack<T, VEC> (&hi)[K][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const typename Acc<T>::type av = widen(a[i].v[v]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T w = (v + S < VEC) ? lo[k][i].v[(v + S) % VEC]
                                  : hi[k][i].v[(v + S) % VEC];
        acc[k][v] = mad(av, widen(w), acc[k][v]);
      }
    }
  }
}

// The shift s (0 <= s < VEC) is uniform over the grid: a branch per value.
template <int S, typename T, int M, int VEC, int K>
__device__ __forceinline__ void accumulate_shifted(
    int s, typename Acc<T>::type (&acc)[K][VEC], const Pack<T, VEC> (&a)[M],
    const Pack<T, VEC> (&lo)[K][M], const Pack<T, VEC> (&hi)[K][M]) {
  if (s == S) {
    accumulate<S, T, M, VEC, K>(acc, a, lo, hi);
  } else if constexpr (S + 1 < VEC) {
    accumulate_shifted<S + 1, T, M, VEC, K>(s, acc, a, lo, hi);
  }
}

// The body for the narrow banks: M terms, VEC rows a thread, K operands.
template <typename T, int M, int VEC, int K, typename OFFS>
__device__ __forceinline__ void dia_rows_narrow(
    const OFFS& offs, const T* __restrict__ data,
    const T* const (&W)[K], typename Acc<T>::type* const (&y)[K], int64_t n,
    int ndiag) {
  using A = typename Acc<T>::type;
  using P = Pack<T, VEC>;
  constexpr int DC = Chunk<T, M, VEC, K>::diagonals;
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (r >= n) return;  // n is a multiple of VEC: a thread has all its rows
  const int64_t term_stride = static_cast<int64_t>(ndiag) * n;
  A acc[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[k][v] = A(0);
  }
  for (int d0 = 0; d0 < ndiag; d0 += DC) {
    P a[DC][M];
    P lo[DC][K][M];
    P hi[DC][K][M];
    int s[DC];
    // every load of the chunk ...
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = d0 + j;
      if (d < ndiag) {
        const int off = offs[d];
        s[j] = VEC > 1 ? (off & (VEC - 1)) : 0;
        const int64_t base = r + off - s[j];  // a multiple of VEC
        const T* drow = data + static_cast<int64_t>(d) * n + r;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          a[j][i] = load_pack<T, VEC>(drow + i * term_stride);
        }
        if (base >= 0 && base + (s[j] ? 2 * VEC : VEC) <= n) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int i = 0; i < M; ++i) {
              const T* w = W[k] + i * n + base;
              lo[j][k][i] = load_pack<T, VEC>(w);
              if (s[j]) hi[j][k][i] = load_pack<T, VEC>(w + VEC);
            }
          }
        } else {
          // the window crosses an end of [0, n): element by element, zero
          // outside, only the elements that will be picked
#pragma unroll
          for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int i = 0; i < M; ++i) {
              const T* w = W[k] + i * n;
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                const int64_t c0 = base + e;
                const int64_t c1 = base + VEC + e;
                lo[j][k][i].v[e] =
                    (e >= s[j] && c0 >= 0 && c0 < n) ? w[c0] : T(0.f);
                hi[j][k][i].v[e] =
                    (e < s[j] && c1 >= 0 && c1 < n) ? w[c1] : T(0.f);
              }
            }
          }
        }
      }
    }
    // ... before its first multiply
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      if (d0 + j < ndiag) {
        accumulate_shifted<0, T, M, VEC, K>(s[j], acc, a[j], lo[j], hi[j]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    Pack<A, VEC> out;
#pragma unroll
    for (int v = 0; v < VEC; ++v) out.v[v] = acc[k][v];
    *reinterpret_cast<Pack<A, VEC>*>(y[k] + r) = out;
  }
}

// The narrow body behind the single (K = 1) and the pair (K = 2) entries.
template <typename T, int M, int VEC, typename OFFS>
__global__ void __launch_bounds__(kThreads)
    dia_lincomb_kernel(const __grid_constant__ OFFS offs,
                       const T* __restrict__ data, const T* __restrict__ WT,
                       typename Acc<T>::type* __restrict__ y, int64_t n,
                       int ndiag) {
  const T* const W[1] = {WT};
  typename Acc<T>::type* const out[1] = {y};
  dia_rows_narrow<T, M, VEC, 1>(offs, data, W, out, n, ndiag);
}

template <typename T, int M, int VEC, typename OFFS>
__global__ void __launch_bounds__(kThreads)
    dia_lincomb_pair_kernel(const __grid_constant__ OFFS offs,
                            const T* __restrict__ data,
                            const T* __restrict__ WreT,
                            const T* __restrict__ WimT,
                            typename Acc<T>::type* __restrict__ yre,
                            typename Acc<T>::type* __restrict__ yim, int64_t n,
                            int ndiag) {
  const T* const W[2] = {WreT, WimT};
  typename Acc<T>::type* const out[2] = {yre, yim};
  dia_rows_narrow<T, M, VEC, 2>(offs, data, W, out, n, ndiag);
}

// ---- the generic body ---------------------------------------------------
constexpr int kGroups = 8;                 // runs of the streams
constexpr int kSplitThreads = 32 * kGroups;  // a warp a run
constexpr int kRowThreads = 128;           // a thread a row (group)
constexpr int kGenericSmem = 48 * 1024;    // windows and partial sums

// Offsets and window positions in the parameter block, or behind pointers.
template <int CAP>
struct PlanByValue {
  Clusters cl;
  int off[CAP];
  int pos[CAP];
  __device__ __forceinline__ int offset(int d) const { return off[d]; }
  __device__ __forceinline__ int position(int d) const { return pos[d]; }
};
struct PlanByPointer {
  Clusters cl;
  const int* off;
  const int* pos;
  __device__ __forceinline__ int offset(int d) const { return __ldg(off + d); }
  __device__ __forceinline__ int position(int d) const {
    return __ldg(pos + d);
  }
};

// BYTES (4, 8) from global to shared memory without a register round trip;
// zeros where `inside` is false (the source is then not read).
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool inside) {
#ifdef __CUDA_ARCH__
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(inside ? BYTES : 0)
               : "memory");
#else
  if (inside) {
    memcpy(dst, src, BYTES);
  } else {
    memset(dst, 0, BYTES);
  }
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// One term's window of one cluster: win[e] = src[start + e] for e < len,
// zero outside [0, n).  `words`: bfloat16 moved as aligned pairs (start and
// len even, n even, src 4-byte aligned: a pair is wholly inside or outside).
template <typename T, int THREADS>
__device__ __forceinline__ void stage_row(T* win, const T* src, int64_t start,
                                          int len, int64_t n, bool words) {
  if constexpr (sizeof(T) >= 4) {
    for (int e = threadIdx.x; e < len; e += THREADS) {
      const int64_t c = start + e;
      const bool inside = c >= 0 && c < n;
      copy_async<sizeof(T)>(win + e, inside ? src + c : src, inside);
    }
  } else if (words) {
    for (int e = 2 * threadIdx.x; e < len; e += 2 * THREADS) {
      const int64_t c = start + e;
      const bool inside = c >= 0 && c < n;
      copy_async<4>(win + e, inside ? src + c : src, inside);
    }
  } else {
    // no 2-byte cp.async, and these rows are not 4-byte aligned: through
    // registers
    for (int e = threadIdx.x; e < len; e += THREADS) {
      const int64_t c = start + e;
      win[e] = (c >= 0 && c < n) ? src[c] : T(0.f);
    }
  }
}

// Streams whose loads are in flight together: about 64 registers' worth of
// bank words and operand words read through L1, at most 16.
template <typename T, int K, int R, int VEC>
struct Unroll {
  static constexpr int words =
      (R * VEC * static_cast<int>(sizeof(T)) * (1 + K) + 3) / 4;
  static constexpr int fit = words >= 64 ? 1 : 64 / words;
  static constexpr int value = fit > 16 ? 16 : fit;
};

// Ends a run: tot = p_0 after the first, tot + p_g after each later one.
template <typename A, int K, int R, int VEC>
__device__ __forceinline__ void end_run(A (&acc)[K][R][VEC],
                                        A (&tot)[K][R][VEC], bool first) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        tot[k][j][v] = first ? acc[k][j][v] : tot[k][j][v] + acc[k][j][v];
        acc[k][j][v] = A(0);
      }
    }
  }
}

// The m * ndiag streams (diagonal d outer, term i inner) of a bank fall into
// kGroups fixed runs [b_g, b_{g+1}), b_g = streams * g / kGroups; a row's
// result is p_0 + p_1 + ... + p_7 in that order, p_g the fused multiply-adds
// of run g from zero.  Both kernels below sum so, and so give the same bits.
//
// The split kernel (n ~ 1e4): a block of kGroups warps owns TILE = 32 R VEC
// rows, warp g computes run g for all of them - the operand from the staged
// windows, or through L1 - and the runs meet in shared memory.
// y_k[r] = sum_d sum_i data[i, d, r] * W_k[i, r + off_d]; K = 1 the single,
// K = 2 the pair (W1, y1 unused for K = 1).
template <typename T, int K, int R, int VEC, typename PLAN>
__global__ void __launch_bounds__(kSplitThreads)
    dia_generic_split_kernel(const __grid_constant__ PLAN plan,
                             const T* __restrict__ data,
                             const T* __restrict__ W0,
                             const T* __restrict__ W1,
                             typename Acc<T>::type* __restrict__ y0,
                             typename Acc<T>::type* __restrict__ y1,
                             int64_t n, int m, int ndiag, bool words) {
  using A = typename Acc<T>::type;
  using P = Pack<T, VEC>;
  constexpr int TILE = 32 * R * VEC;
  constexpr int U = Unroll<T, K, R, VEC>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  const T* const W[2] = {W0, W1};
  A* const y[2] = {y0, y1};
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * TILE;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int window = plan.cl.window;

  // 1. every staged cluster's window of every term, for this tile
  for (int c = 0; c < plan.cl.count; ++c) {
    const int64_t start = r0 + plan.cl.start[c];
    for (int k = 0; k < K; ++k) {
      for (int i = 0; i < m; ++i) {
        stage_row<T, kSplitThreads>(
            win + (k * m + i) * window + plan.cl.base[c],
            W[k] + static_cast<int64_t>(i) * n, start, plan.cl.len[c], n,
            words);
      }
    }
  }
  copy_async_wait();
  __syncthreads();

  // 2. this warp's run of the streams, in order
  const int64_t streams = static_cast<int64_t>(ndiag) * m;
  const int s_begin = static_cast<int>(streams * g / kGroups);
  const int s_end = static_cast<int>(streams * (g + 1) / kGroups);
  const int64_t term_stride = static_cast<int64_t>(ndiag) * n;
  A acc[K][R][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[k][j][v] = A(0);
    }
  }
  int d = s_begin / m;
  int i = s_begin - d * m;
  for (int s0 = s_begin; s0 < s_end; s0 += U) {
    P a[U][R];
    T wd[U][K][R][VEC];  // operand words read through L1
    int iu[U], pu[U];
    // every load of the U streams ...
#pragma unroll
    for (int u = 0; u < U; ++u) {
      iu[u] = i;
      pu[u] = -1;
      if (s0 + u < s_end) {
        const int off = plan.offset(d);
        const int pos = plan.position(d);
        pu[u] = pos;
        const T* drow = data + static_cast<int64_t>(i) * term_stride +
                        static_cast<int64_t>(d) * n;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int64_t r = r0 + (lane + 32 * j) * VEC;
          if (r < n) {  // n is a multiple of VEC: a lane has all its rows
            a[u][j] = load_pack<T, VEC>(drow + r);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) a[u][j].v[v] = T(0.f);
          }
          if (pos < 0) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const T* w = W[k] + static_cast<int64_t>(i) * n;
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                const int64_t c = r + v + off;
                wd[u][k][j][v] = (c >= 0 && c < n) ? __ldg(w + c) : T(0.f);
              }
            }
          }
        }
      }
      if (++i == m) {
        i = 0;
        ++d;
      }
    }
    // ... before the first multiply
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u >= s_end) continue;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (pu[u] >= 0) {
          const T* ws = win + (k * m + iu[u]) * window + pu[u];
#pragma unroll
          for (int j = 0; j < R; ++j) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              acc[k][j][v] = mad(widen(a[u][j].v[v]),
                                 widen(ws[(lane + 32 * j) * VEC + v]),
                                 acc[k][j][v]);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < R; ++j) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              acc[k][j][v] = mad(widen(a[u][j].v[v]), widen(wd[u][k][j][v]),
                                 acc[k][j][v]);
            }
          }
        }
      }
    }
  }

  // 3. the runs' sums, added in warp order
  __syncthreads();  // every warp is done with the windows
  A* part = reinterpret_cast<A*>(smem);  // [kGroups][K][TILE]
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        part[(g * K + k) * TILE + (lane + 32 * j) * VEC + v] = acc[k][j][v];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < K * TILE; e += kSplitThreads) {
    const int k = e / TILE;
    const int t = e - k * TILE;
    const int64_t r = r0 + t;
    if (r < n) {
      A sum = part[k * TILE + t];
#pragma unroll
      for (int h = 1; h < kGroups; ++h) sum += part[(h * K + k) * TILE + t];
      y[k][r] = sum;
    }
  }
}

// The rows kernel (n ~ 1e6: blocks enough): a block of 128 threads owns
// TILE = 128 R VEC rows; each thread walks all streams for its R groups of
// VEC rows (r = r0 + (tid + 128 j) VEC + v: each load a warp makes is one
// coalesced segment), the operand through L1 (neighbouring diagonals share
// its lines), U streams' loads in flight, and adds each run's sum as the run
// ends.  Per stream a thread only steps two pointers and tests one bound.
template <typename T, int K, int R, int VEC, typename PLAN>
__global__ void __launch_bounds__(kRowThreads, 6)
    dia_generic_rows_kernel(const __grid_constant__ PLAN plan,
                            const T* __restrict__ data,
                            const T* __restrict__ W0,
                            const T* __restrict__ W1,
                            typename Acc<T>::type* __restrict__ y0,
                            typename Acc<T>::type* __restrict__ y1,
                            int64_t n, int m, int ndiag) {
  using A = typename Acc<T>::type;
  using P = Pack<T, VEC>;
  constexpr int TILE = kRowThreads * R * VEC;
  // streams in flight: about 40 registers of loads, 4 at most (6 blocks of
  // 128 threads an SM leave 85 registers a thread)
  constexpr int WORD = sizeof(T) > 4 ? static_cast<int>(sizeof(T)) / 4 : 1;
  constexpr int PER_STREAM =
      R * ((VEC * static_cast<int>(sizeof(T)) + 3) / 4 + K * VEC * WORD);
  constexpr int U = 40 / PER_STREAM < 1 ? 1
                    : (40 / PER_STREAM > 4 ? 4 : 40 / PER_STREAM);
  const T* const W[2] = {W0, W1};
  A* const y[2] = {y0, y1};
  const int64_t rbase =
      static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x * VEC;
  const int streams = ndiag * m;
  const int64_t term_stride = static_cast<int64_t>(ndiag) * n;
  A acc[K][R][VEC];
  A tot[K][R][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[k][j][v] = tot[k][j][v] = A(0);
    }
  }
  int run = 0;
  int run_end = streams / kGroups;
  int d = 0;
  int i = 0;
  int off = plan.offset(0);
  const T* dp = data + rbase;  // data[i, d, rbase]
  int64_t wi = 0;              // i * n
  for (int s0 = 0; s0 < streams; s0 += U) {
    P a[U][R];
    T w[U][K][R][VEC];
    // every load of the U streams ...
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < streams) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int64_t r = rbase + static_cast<int64_t>(j) * kRowThreads *
                                        VEC;
          if (r < n) {  // n is a multiple of VEC: a thread has all its rows
            a[u][j] = load_pack<T, VEC>(dp + j * kRowThreads * VEC);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) a[u][j].v[v] = T(0.f);
          }
#pragma unroll
          for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const int64_t c = r + v + off;
              w[u][k][j][v] =
                  (c >= 0 && c < n) ? __ldg(W[k] + wi + c) : T(0.f);
            }
          }
        }
        if (++i == m) {
          i = 0;
          ++d;
          dp = data + static_cast<int64_t>(d) * n + rbase;
          wi = 0;
          if (d < ndiag) off = plan.offset(d);
        } else {
          dp += term_stride;
          wi += n;
        }
      }
    }
    // ... before the first multiply
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u >= streams) continue;
      while (s0 + u == run_end) {
        end_run<A, K, R, VEC>(acc, tot, run == 0);
        ++run;
        run_end = static_cast<int>(static_cast<int64_t>(streams) * (run + 1) /
                                   kGroups);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            acc[k][j][v] = mad(widen(a[u][j].v[v]), widen(w[u][k][j][v]),
                               acc[k][j][v]);
          }
        }
      }
    }
  }
  // the runs still open (the last, and empty ones), then the rows
  for (; run < kGroups; ++run) end_run<A, K, R, VEC>(acc, tot, run == 0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t r = rbase + static_cast<int64_t>(j) * kRowThreads * VEC;
      if (r < n) {
        Pack<A, VEC> out;
#pragma unroll
        for (int v = 0; v < VEC; ++v) out.v[v] = tot[k][j][v];
        *reinterpret_cast<Pack<A, VEC>*>(y[k] + r) = out;
      }
    }
  }
}

// One launch of the narrow body: K = 1 the single kernel (W1, y1 unused),
// K = 2 the pair.
template <typename T, int K, int M, int VEC, typename OFFS>
void launch_kernel(const OFFS& offs, const DiaBank& b, const void* W0,
                   const void* W1, void* y0, void* y1, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const long long per_block = static_cast<long long>(kThreads) * VEC;
  const unsigned int blocks =
      static_cast<unsigned int>((b.n + per_block - 1) / per_block);
  const T* data = static_cast<const T*>(b.data);
  if constexpr (K == 1) {
    dia_lincomb_kernel<T, M, VEC, OFFS><<<blocks, kThreads, 0, stream>>>(
        offs, data, static_cast<const T*>(W0), static_cast<A*>(y0),
        static_cast<int64_t>(b.n), b.ndiag);
  } else {
    dia_lincomb_pair_kernel<T, M, VEC, OFFS><<<blocks, kThreads, 0, stream>>>(
        offs, data, static_cast<const T*>(W0), static_cast<const T*>(W1),
        static_cast<A*>(y0), static_cast<A*>(y1), static_cast<int64_t>(b.n),
        b.ndiag);
  }
}

// One launch of the split kernel: 2 rows a lane.
template <typename T, int K, int VEC, typename PLAN>
int launch_generic_split(const PLAN& plan, const DiaBank& b, const void* W0,
                         const void* W1, void* y0, void* y1, bool words,
                         cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr int R = 2;
  constexpr int TILE = 32 * R * VEC;
  const long long win_bytes = static_cast<long long>(K) * b.m *
                              b.clusters.window *
                              static_cast<long long>(sizeof(T));
  const long long part_bytes =
      static_cast<long long>(kGroups) * K * TILE * sizeof(A);
  const long long smem_bytes = win_bytes > part_bytes ? win_bytes : part_bytes;
  if (b.rows != R || smem_bytes > kGenericSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int blocks =
      static_cast<unsigned int>((b.n + TILE - 1) / TILE);
  dia_generic_split_kernel<T, K, R, VEC, PLAN>
      <<<blocks, kSplitThreads, static_cast<size_t>(smem_bytes), stream>>>(
          plan, static_cast<const T*>(b.data), static_cast<const T*>(W0),
          static_cast<const T*>(K == 2 ? W1 : W0), static_cast<A*>(y0),
          static_cast<A*>(K == 2 ? y1 : y0), static_cast<int64_t>(b.n), b.m,
          b.ndiag, words);
  return 0;
}

// One launch of the rows kernel: 4 row groups a thread (2 of double or of
// bfloat16 pairs).
template <typename T, int K, int VEC, typename PLAN>
int launch_generic_rows(const PLAN& plan, const DiaBank& b, const void* W0,
                        const void* W1, void* y0, void* y1,
                        cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr int R = sizeof(T) == 8 || VEC == 2 ? 2 : 4;
  constexpr int TILE = kRowThreads * R * VEC;
  // the rows kernel stages nothing; its results are written VEC at a time
  if (b.rows != R || b.clusters.count != 0 ||
      (VEC > 1 && ((reinterpret_cast<uintptr_t>(y0) |
                    reinterpret_cast<uintptr_t>(K == 2 ? y1 : y0)) &
                   (sizeof(A) * VEC - 1)) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int blocks =
      static_cast<unsigned int>((b.n + TILE - 1) / TILE);
  dia_generic_rows_kernel<T, K, R, VEC, PLAN>
      <<<blocks, kRowThreads, 0, stream>>>(
          plan, static_cast<const T*>(b.data), static_cast<const T*>(W0),
          static_cast<const T*>(K == 2 ? W1 : W0), static_cast<A*>(y0),
          static_cast<A*>(K == 2 ? y1 : y0), static_cast<int64_t>(b.n), b.m,
          b.ndiag);
  return 0;
}

template <typename T, int K, int VEC, typename PLAN>
int launch_generic_regime(const PLAN& plan, const DiaBank& b, const void* W0,
                          const void* W1, void* y0, void* y1, bool words,
                          cudaStream_t stream) {
  if (b.split) {
    return launch_generic_split<T, K, VEC>(plan, b, W0, W1, y0, y1, words,
                                           stream);
  }
  return launch_generic_rows<T, K, VEC>(plan, b, W0, W1, y0, y1, stream);
}

template <typename T, int K, typename PLAN>
int launch_generic_plan(const PLAN& plan, const DiaBank& b, const void* W0,
                        const void* W1, void* y0, void* y1,
                        cudaStream_t stream) {
  // bfloat16 windows move as aligned pairs where every term row is aligned
  const bool words = sizeof(T) == 2 && b.n % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(W0) & 3) == 0 &&
                     (K == 1 || (reinterpret_cast<uintptr_t>(W1) & 3) == 0);
  if constexpr (sizeof(T) == 2) {
    if (b.gvec == 2) {
      if (b.n % 2 != 0 || (reinterpret_cast<uintptr_t>(b.data) & 3) != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return launch_generic_regime<T, K, 2>(plan, b, W0, W1, y0, y1, words,
                                            stream);
    }
  }
  if (b.gvec != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_generic_regime<T, K, 1>(plan, b, W0, W1, y0, y1, words,
                                        stream);
}

template <typename T, int K>
int launch_generic(const DiaBank& b, const void* W0, const void* W1, void* y0,
                   void* y1, cudaStream_t stream) {
  const Clusters& cl = b.clusters;
  if (cl.count < 0 || cl.count > kMaxClusters || cl.window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b.ndiag <= kMaxByValue) {
    PlanByValue<kMaxByValue> plan;
    plan.cl = cl;
    for (int d = 0; d < kMaxByValue; ++d) {
      plan.off[d] = d < b.ndiag ? b.offsets[d] : 0;
      plan.pos[d] = d < b.ndiag ? b.pos[d] : -1;
    }
    return launch_generic_plan<T, K>(plan, b, W0, W1, y0, y1, stream);
  }
  if (b.offsets_dev == nullptr || b.pos_dev == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PlanByPointer plan;
  plan.cl = cl;
  plan.off = b.offsets_dev;
  plan.pos = b.pos_dev;
  return launch_generic_plan<T, K>(plan, b, W0, W1, y0, y1, stream);
}

template <typename T, int K, int M>
bool launch_narrow(const DiaBank& b, int vec, const void* W0, const void* W1,
                   void* y0, void* y1, cudaStream_t stream) {
  ByValue<kNarrow> offs;
  for (int d = 0; d < b.ndiag; ++d) offs.v[d] = b.offsets[d];
  for (int d = b.ndiag; d < kNarrow; ++d) offs.v[d] = 0;
  if (vec == 1) {
    launch_kernel<T, K, M, 1>(offs, b, W0, W1, y0, y1, stream);
    return true;
  }
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) {
      launch_kernel<T, K, M, 8>(offs, b, W0, W1, y0, y1, stream);
      return true;
    }
  }
  return false;  // packed rows are built for bfloat16 only
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int K>
int launch(const DiaBank* bank, const void* W0, const void* W1, void* y0,
           void* y1, void* raw_stream) {
  const DiaBank& b = *bank;
  cudaStream_t stream = static_cast<cudaStream_t>(raw_stream);
  if (b.n < 0 || b.m < 1 || b.ndiag < 1 || b.vec < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b.n == 0) return static_cast<int>(cudaGetLastError());
  if (b.ndiag <= kNarrow && b.m <= kMaxTerms) {
    int vec = b.vec;
    if (vec > 1 && (b.n % vec != 0 || !aligned16(b.data) || !aligned16(W0) ||
                    !aligned16(y0) ||
                    (K == 2 && (!aligned16(W1) || !aligned16(y1))))) {
      vec = 1;  // packed words need aligned rows
    }
    bool ok = false;
    switch (b.m) {
      case 1: ok = launch_narrow<T, K, 1>(b, vec, W0, W1, y0, y1, stream); break;
      case 2: ok = launch_narrow<T, K, 2>(b, vec, W0, W1, y0, y1, stream); break;
      case 3: ok = launch_narrow<T, K, 3>(b, vec, W0, W1, y0, y1, stream); break;
      case 4: ok = launch_narrow<T, K, 4>(b, vec, W0, W1, y0, y1, stream); break;
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const int rc = launch_generic<T, K>(b, W0, W1, y0, y1, stream);
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void dia_noop_kernel() {}

}  // namespace

extern "C" {

int dia_lincomb_f32(const DiaBank* bank, const void* WT, void* y,
                    void* stream) {
  return launch<float, 1>(bank, WT, nullptr, y, nullptr, stream);
}

int dia_lincomb_f64(const DiaBank* bank, const void* WT, void* y,
                    void* stream) {
  return launch<double, 1>(bank, WT, nullptr, y, nullptr, stream);
}

int dia_lincomb_pair_f32(const DiaBank* bank, const void* WreT,
                         const void* WimT, void* yre, void* yim,
                         void* stream) {
  return launch<float, 2>(bank, WreT, WimT, yre, yim, stream);
}

int dia_lincomb_pair_f64(const DiaBank* bank, const void* WreT,
                         const void* WimT, void* yre, void* yim,
                         void* stream) {
  return launch<double, 2>(bank, WreT, WimT, yre, yim, stream);
}

// bf16 bank and operands, float results (y, yre, yim point to float).
int dia_lincomb_bf16(const DiaBank* bank, const void* WT, void* y,
                     void* stream) {
  return launch<__nv_bfloat16, 1>(bank, WT, nullptr, y, nullptr, stream);
}

int dia_lincomb_pair_bf16(const DiaBank* bank, const void* WreT,
                          const void* WimT, void* yre, void* yim,
                          void* stream) {
  return launch<__nv_bfloat16, 2>(bank, WreT, WimT, yre, yim, stream);
}

// An empty launch on the caller's stream: the floor any call pays.
int dia_noop(void* stream) {
  dia_noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* dia_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
