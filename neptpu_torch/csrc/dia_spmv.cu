// Stacked-DIA fused multi-term SpMV for Hopper (sm_90a):
//
//     y[r] = sum_d sum_i data[i, d, r] * W[r + off_d, i]
//
// with W read as zero outside [0, n).  This is the fused compute_Mlincomb
// contraction y = sum_i A_i W[:, i] over a bank of m banded terms that share
// ndiag diagonal offsets.  It replaces the TPU Pallas kernel
// neptpu/ops/pallas_spmv.py:_dia_kernel / dia_lincomb_pallas_padded.
//
// What bounds it: memory bandwidth.  Each output row does 2 m ndiag flops
// against m ndiag bank words, so the compulsory device-memory traffic is
// m*ndiag*n bank words + n*m operand words + n output words, and the
// arithmetic is far below what the card can do per byte.
//
// What this simple design does about it: one thread per output row, so for
// every (i, d) the bank reads data[i, d, r] of a warp are 32 consecutive
// words (coalesced, each read exactly once).  The operand W (n, m) row-major
// is re-read once per diagonal by neighbouring rows; those repeated reads are
// left to L1/L2 (a row window of W is a few KB per block).  Shared-memory
// operand windows and TMA staging are later work.
//
// The pair entry points apply one bank to two operands (the re and im channels
// of the complex-as-real scan) in ONE launch: each thread keeps two
// accumulators and loads every data[i, d, r] once for both, so the bank — the
// bulk of the traffic — is read once instead of twice.  Each output is summed
// in the same order as the single-operand kernel sums it, so the pair's
// results equal two single launches bit for bit.
//
// Layouts (all contiguous, row-major): data (m, ndiag, n), offsets (ndiag,)
// int32 on the device, W (n, m), y (n,); the pair takes Wre, Wim (n, m) and
// writes yre, yim (n,).  Accumulation is in the data type.
// The kernel allocates nothing and does not synchronise; it is launched on the
// caller's stream, and the C entry points return cudaGetLastError().
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void dia_lincomb_kernel(const T* __restrict__ data,
                                   const int* __restrict__ offsets,
                                   const T* __restrict__ W,
                                   T* __restrict__ y,
                                   int64_t n, int m, int ndiag) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  T acc = T(0);
  for (int d = 0; d < ndiag; ++d) {
    const int64_t c = r + static_cast<int64_t>(__ldg(offsets + d));
    if (c < 0 || c >= n) continue;  // never read outside [0, n)
    const T* wrow = W + c * m;
    const T* drow = data + static_cast<int64_t>(d) * n + r;
    for (int i = 0; i < m; ++i) {
      acc += drow[static_cast<int64_t>(i) * ndiag * n] * wrow[i];
    }
  }
  y[r] = acc;
}

template <typename T>
__global__ void dia_lincomb_pair_kernel(const T* __restrict__ data,
                                        const int* __restrict__ offsets,
                                        const T* __restrict__ Wre,
                                        const T* __restrict__ Wim,
                                        T* __restrict__ yre,
                                        T* __restrict__ yim,
                                        int64_t n, int m, int ndiag) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  T acc_re = T(0);
  T acc_im = T(0);
  for (int d = 0; d < ndiag; ++d) {
    const int64_t c = r + static_cast<int64_t>(__ldg(offsets + d));
    if (c < 0 || c >= n) continue;  // never read outside [0, n)
    const T* wre = Wre + c * m;
    const T* wim = Wim + c * m;
    const T* drow = data + static_cast<int64_t>(d) * n + r;
    for (int i = 0; i < m; ++i) {
      const T a = drow[static_cast<int64_t>(i) * ndiag * n];  // read once
      acc_re += a * wre[i];
      acc_im += a * wim[i];
    }
  }
  yre[r] = acc_re;
  yim[r] = acc_im;
}

template <typename T>
int launch(const void* data, const void* offsets, const void* W, void* y,
           long long n, int m, int ndiag, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    dia_lincomb_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(data), static_cast<const int*>(offsets),
        static_cast<const T*>(W), static_cast<T*>(y),
        static_cast<int64_t>(n), m, ndiag);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pair(const void* data, const void* offsets, const void* Wre,
                const void* Wim, void* yre, void* yim, long long n, int m,
                int ndiag, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    dia_lincomb_pair_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(data), static_cast<const int*>(offsets),
        static_cast<const T*>(Wre), static_cast<const T*>(Wim),
        static_cast<T*>(yre), static_cast<T*>(yim),
        static_cast<int64_t>(n), m, ndiag);
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void dia_noop_kernel() {}

}  // namespace

extern "C" {

int dia_lincomb_f32(const void* data, const void* offsets, const void* W,
                    void* y, long long n, int m, int ndiag, void* stream) {
  return launch<float>(data, offsets, W, y, n, m, ndiag, stream);
}

int dia_lincomb_f64(const void* data, const void* offsets, const void* W,
                    void* y, long long n, int m, int ndiag, void* stream) {
  return launch<double>(data, offsets, W, y, n, m, ndiag, stream);
}

int dia_lincomb_pair_f32(const void* data, const void* offsets,
                         const void* Wre, const void* Wim, void* yre,
                         void* yim, long long n, int m, int ndiag,
                         void* stream) {
  return launch_pair<float>(data, offsets, Wre, Wim, yre, yim, n, m, ndiag,
                            stream);
}

int dia_lincomb_pair_f64(const void* data, const void* offsets,
                         const void* Wre, const void* Wim, void* yre,
                         void* yim, long long n, int m, int ndiag,
                         void* stream) {
  return launch_pair<double>(data, offsets, Wre, Wim, yre, yim, n, m, ndiag,
                             stream);
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
