// Batched tridiagonal (Thomas) solve for Hopper (sm_90a).
//
// Replaces thetis_tpu/kernels/tridiag.py::_thomas_kernel (the Pallas TPU
// kernel behind _pallas_thomas / tridiag_solve), which every implicit
// vertical column solve of the 3D step reaches: the vertical viscosity of
// both velocity components and the vertical diffusion of the tracers.
//
//   dl[i] x[i-1] + dd[i] x[i] + du[i] x[i+1] = rhs[i],  i = 0..n-1
//
// for B independent columns, all operands (B, n) row-major (each column's
// n values contiguous); dl[0] and du[n-1] are ignored.  The recurrence is
// the reference's _thomas_scan one, divisions and all, so the f64 kernel
// matches the CPU plain path to roundoff.
//
// Design: one thread per column, 256-thread blocks.  The forward sweep
// keeps the running cp/dp in registers and stores cp to a scratch buffer
// and dp straight into x; the back substitution then runs in place on x.
// Any n works (no unroll bound: the TPU version fell back to a scan above
// 256 rows, here there is nothing to fall back to).  A thread reads its
// column's n consecutive values, so a warp's first load touches 32 rows of
// n values each and the following loads hit L1.
//
// Bound: device-memory bytes.  Per call the 4 operands are read once and
// x written once (5 n B sizeof(T) bytes, 7.2 MB in f32 for the bench's
// velocity solve, B = 27,648 columns of n = 13: ~2 us at 3.35 TB/s); the
// cp scratch and the in-place back substitution add 4 n B sizeof(T) more,
// which stay in L2 at these sizes.  At the bench's sizes the launch itself
// dominates.  The measured time sits beside this bound in PERF.md.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
tridiag_kernel(const T* __restrict__ dl, const T* __restrict__ dd,
               const T* __restrict__ du, const T* __restrict__ rhs,
               T* __restrict__ x, T* __restrict__ cp, long long batch,
               int n) {
  const long long col = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (col >= batch) return;
  const long long o = col * n;
  T c_prev = T(0);
  T d_prev = T(0);
  for (int i = 0; i < n; ++i) {
    const T l = dl[o + i];
    const T m = dd[o + i] - l * c_prev;
    c_prev = du[o + i] / m;
    d_prev = (rhs[o + i] - l * d_prev) / m;
    cp[o + i] = c_prev;
    x[o + i] = d_prev;
  }
  T x_next = T(0);
  for (int i = n - 1; i >= 0; --i) {
    x_next = x[o + i] - cp[o + i] * x_next;
    x[o + i] = x_next;
  }
}

template <typename T>
int launch(const T* dl, const T* dd, const T* du, const T* rhs, T* x, T* cp,
           long long batch, int n, cudaStream_t stream) {
  const long long grid = (batch + THREADS - 1) / THREADS;
  tridiag_kernel<T><<<(unsigned int)grid, THREADS, 0, stream>>>(
      dl, dd, du, rhs, x, cp, batch, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
int tridiag_f32(const float* dl, const float* dd, const float* du,
                const float* rhs, float* x, float* cp, long long batch,
                int n, cudaStream_t stream) {
  return launch<float>(dl, dd, du, rhs, x, cp, batch, n, stream);
}

int tridiag_f64(const double* dl, const double* dd, const double* du,
                const double* rhs, double* x, double* cp, long long batch,
                int n, cudaStream_t stream) {
  return launch<double>(dl, dd, du, rhs, x, cp, batch, n, stream);
}

}  // extern "C"
