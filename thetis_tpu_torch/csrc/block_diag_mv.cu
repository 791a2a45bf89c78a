// Per-cell block-diagonal apply (block-Jacobi) for Hopper (sm_90a).
//
// Replaces thetis_tpu/kernels/ringmv.py::_bjac_kernel (the Pallas TPU
// kernel behind _bjac_call / block_diag_mv_pallas).  The same function is
// the preconditioner of every FGMRES iteration of the assembled ring solve
// (thetis_tpu/solvers/assembled.py, the einsum "ijc,jc->ic"):
//
//   z[i, c] = sum_k D[i, k, c] * r[k, c]
//
// with D (9, 9, nc) the inverted diagonal blocks and r, z (9, nc), all
// component-major (cell index fastest).
//
// Design: one thread per cell, 256-thread blocks.  The 9 values of r go to
// registers, the 81 block entries are streamed, the 9 sums stay in
// registers.  With the cell index fastest every one of the 81 + 9 + 9
// accesses per cell is coalesced across the warp.
//
// Bound: device-memory bytes, (81 + 18) nc sizeof(T) per call: 1.8 MB in
// f32 at the 3D bench's nc = 4,608 (launch-bound, ~0.5 us of traffic) and
// 40.6 MB at the 2D CN bench's nc = 102,400 (~12 us at 3.35 TB/s).  The
// measured time sits beside this bound in PERF.md.
#include <cuda_runtime.h>

namespace {

constexpr int D = 9;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_diag_mv_kernel(const T* __restrict__ diag, const T* __restrict__ r,
                     T* __restrict__ z, long long nc) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= nc) return;
  T rk[D];
#pragma unroll
  for (int k = 0; k < D; ++k) rk[k] = r[k * nc + c];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) acc += diag[(i * D + k) * nc + c] * rk[k];
    z[i * nc + c] = acc;
  }
}

template <typename T>
int launch(const T* diag, const T* r, T* z, long long nc,
           cudaStream_t stream) {
  const long long grid = (nc + THREADS - 1) / THREADS;
  block_diag_mv_kernel<T><<<(unsigned int)grid, THREADS, 0, stream>>>(
      diag, r, z, nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
int block_diag_mv_f32(const float* diag, const float* r, float* z,
                      long long nc, cudaStream_t stream) {
  return launch<float>(diag, r, z, nc, stream);
}

int block_diag_mv_f64(const double* diag, const double* r, double* z,
                      long long nc, cudaStream_t stream) {
  return launch<double>(diag, r, z, nc, stream);
}

}  // extern "C"
