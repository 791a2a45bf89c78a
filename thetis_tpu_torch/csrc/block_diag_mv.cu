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
// What bounds it.  Each entry of D is read once for one multiply-add (0.5
// flop per byte in f32), so the bound is the bytes, (81 + 18) nc
// sizeof(T) per call: 40.6 MB in f32 at the 2D CN bench's nc = 102,400
// (12.1 us at 3.35 TB/s; a caller that applies the same D again finds
// much of it in the 50 MB L2) and 1.8 MB at the 3D step's nc = 4,608
// (0.55 us), where a launch and one load latency are the time and the
// grid must fill the card.  Tensor cores and TMA do not apply: nothing is
// reused, and the loads below are already coalesced rows.
//
// Design.  The earlier design ran one thread per cell (18 CTAs of 256 at
// nc 4,608, where its note said "launch-bound, ~0.5 us" of traffic; 2.8 us
// there and 10.1 us at nc 102,400 in f32 on an H100 80GB HBM3 at 700 W,
// both timed back to back, so at nc 102,400 with D still in the L2).  Now
// one thread per (cell, row) at every nc: a CTA takes TC = 32 consecutive
// cells x 9 rows, 288 threads (144 CTAs at nc 4,608, so every SM has
// work).  Thread (i, cell) issues its 9 loads D[i, k, c] and its 9
// r[k, c] at once (coalesced: a warp's 32 cells are 32 consecutive values
// for a fixed (i, k); the 9 row-warps of a CTA read the same r, so 8 of
// them hit L1).  Staging r through shared memory was tried on the card and
// lost at nc 4,608: the barrier holds each warp until the CTA's slowest
// load arrives.  At nc 102,400 the solvers run a ring matvec (142 MB)
// between two applications, so D comes from device memory; timed that way
// (L2 flushed before each call, chip_ab.py, same card) this grid matched
// one thread per cell in f32 (19.1 against 18.7-19.5 us) and was 11%
// ahead in f64 (34.5 against 38.8-39.9 us).  Back to back, with D left in
// the L2, it was ~15% behind in f32: a time no caller sees.  k is summed
// in the plain version's order, so f64 stays at its roundoff; the last
// tile is masked.
#include <cuda_runtime.h>

namespace {

constexpr int D = 9;
constexpr int TC = 32;            // cells per tile (one warp's width)
constexpr int THREADS = TC * D;   // one thread per (cell, row)

// One thread per (cell, row); a warp is one row of 32 cells.
template <typename T>
__global__ void __launch_bounds__(THREADS)
block_diag_mv_kernel(const T* __restrict__ diag, const T* __restrict__ r,
                   T* __restrict__ z, long long nc) {
  const int lane = threadIdx.x % TC;
  const int i = threadIdx.x / TC;
  const long long c = (long long)blockIdx.x * TC + lane;
  if (c >= nc) return;
  const T* di = diag + (long long)(i * D) * nc + c;
  T d[D], rk[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    d[k] = di[k * nc];
    rk[k] = r[k * nc + c];
  }
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < D; ++k) acc += d[k] * rk[k];
  z[i * nc + c] = acc;
}

template <typename T>
int launch(const T* diag, const T* r, T* z, long long nc,
           cudaStream_t stream) {
  const long long grid = (nc + TC - 1) / TC;
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
