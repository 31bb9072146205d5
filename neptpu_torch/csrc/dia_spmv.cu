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
// Behind the narrow body sits a generic one (any m, any ndiag, one row per
// thread, offsets by value up to 256 and from a device array beyond).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kMaxByValue = 256;  // offsets that fit the parameter block

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
};

namespace {

constexpr int kNarrow = 16;       // widest bank of the templated body
constexpr int kMaxTerms = 4;      // most terms of the templated body
constexpr int kThreads = 128;     // threads per block, at every size

// Offsets in the parameter block, or behind a device pointer.
template <int CAP>
struct ByValue {
  int v[CAP];
  __device__ __forceinline__ int operator[](int d) const { return v[d]; }
};
struct ByPointer {
  const int* p;
  __device__ __forceinline__ int operator[](int d) const {
    return __ldg(p + d);
  }
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

// The generic body: any m and ndiag, one row a thread.
template <typename T, int K, typename OFFS>
__device__ __forceinline__ void dia_rows_generic(
    const OFFS& offs, const T* __restrict__ data,
    const T* const (&W)[K], typename Acc<T>::type* const (&y)[K], int64_t n,
    int m, int ndiag) {
  using A = typename Acc<T>::type;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int64_t term_stride = static_cast<int64_t>(ndiag) * n;
  A acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = A(0);
#pragma unroll 4
  for (int d = 0; d < ndiag; ++d) {
    const int64_t c = r + offs[d];
    if (c < 0 || c >= n) continue;  // never read outside [0, n)
    const T* drow = data + static_cast<int64_t>(d) * n + r;
    for (int i = 0; i < m; ++i) {
      const A av = widen(drow[i * term_stride]);  // once for every operand
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[k] = mad(av, widen(W[k][i * n + c]), acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) y[k][r] = acc[k];
}

// M > 0: the narrow body with M terms; M == 0: the generic body.
template <typename T, int M, int VEC, typename OFFS>
__global__ void __launch_bounds__(kThreads)
    dia_lincomb_kernel(const __grid_constant__ OFFS offs,
                       const T* __restrict__ data, const T* __restrict__ WT,
                       typename Acc<T>::type* __restrict__ y, int64_t n, int m,
                       int ndiag) {
  const T* const W[1] = {WT};
  typename Acc<T>::type* const out[1] = {y};
  if constexpr (M > 0) {
    dia_rows_narrow<T, M, VEC, 1>(offs, data, W, out, n, ndiag);
  } else {
    dia_rows_generic<T, 1>(offs, data, W, out, n, m, ndiag);
  }
}

template <typename T, int M, int VEC, typename OFFS>
__global__ void __launch_bounds__(kThreads)
    dia_lincomb_pair_kernel(const __grid_constant__ OFFS offs,
                            const T* __restrict__ data,
                            const T* __restrict__ WreT,
                            const T* __restrict__ WimT,
                            typename Acc<T>::type* __restrict__ yre,
                            typename Acc<T>::type* __restrict__ yim, int64_t n,
                            int m, int ndiag) {
  const T* const W[2] = {WreT, WimT};
  typename Acc<T>::type* const out[2] = {yre, yim};
  if constexpr (M > 0) {
    dia_rows_narrow<T, M, VEC, 2>(offs, data, W, out, n, ndiag);
  } else {
    dia_rows_generic<T, 2>(offs, data, W, out, n, m, ndiag);
  }
}

// One launch: K = 1 the single kernel (W1, y1 unused), K = 2 the pair.
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
        static_cast<int64_t>(b.n), b.m, b.ndiag);
  } else {
    dia_lincomb_pair_kernel<T, M, VEC, OFFS><<<blocks, kThreads, 0, stream>>>(
        offs, data, static_cast<const T*>(W0), static_cast<const T*>(W1),
        static_cast<A*>(y0), static_cast<A*>(y1), static_cast<int64_t>(b.n),
        b.m, b.ndiag);
  }
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
  } else if (b.ndiag <= kMaxByValue) {
    ByValue<kMaxByValue> offs;
    for (int d = 0; d < kMaxByValue; ++d) offs.v[d] = b.offsets[d];
    launch_kernel<T, K, 0, 1>(offs, b, W0, W1, y0, y1, stream);
  } else {
    if (b.offsets_dev == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    launch_kernel<T, K, 0, 1>(ByPointer{b.offsets_dev}, b, W0, W1, y0, y1,
                              stream);
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
