// Assembled 1-ring block matvec for Hopper (sm_90a).
//
// Replaces thetis_tpu/kernels/ringmv.py::_mv_kernel (the Pallas TPU
// kernel behind ring_mv_pallas, reached from ShiftStencil.apply_T).
//
//   y[i, c] = sum_{s valid} sum_k B[s, i, k, c] * x[k, ring[c, s]]
//
// blocks (NS=4, D=9, D=9, nc), x and y (D, nc), all component-major (cell
// index fastest); ring (nc, 4) int32, valid (nc, 4) bytes (0 = boundary
// mirror slot, skipped).  The TPU version pre-shifted the neighbour values
// in XLA (Mosaic cannot load lane-unaligned slices) and left the
// nonconforming rows to a separate correction; here each thread gathers
// its own neighbours through the ring table, so every mesh takes the same
// single launch.
//
// Design: one thread per cell, 256-thread blocks.  For each valid slot the
// 9 neighbour values go to registers, the 9x9 block is streamed and the
// 9 sums stay in registers.  With the cell index fastest, every block
// read is coalesced across the warp; the neighbour gather is the only
// scattered access (9 values per slot, mostly L2 hits since neighbours
// have nearby indices on generated meshes).
//
// Bound: device-memory bytes.  Per call the blocks are read once:
// 4*81*nc*sizeof(T), i.e. 133 MB in f32 at the 2D CN bench size
// (nc = 102,400), plus ~11 MB of vectors, ring and mask: ~44 us at the
// H100's 3.35 TB/s.  The measured time sits beside this bound in PERF.md.
#include <cuda_runtime.h>

namespace {

constexpr int NS = 4;
constexpr int D = 9;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
ring_mv_kernel(const T* __restrict__ blocks, const T* __restrict__ x,
               const int* __restrict__ ring,
               const unsigned char* __restrict__ valid,
               T* __restrict__ y, long long nc) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= nc) return;
  T acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = T(0);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (!valid[c * NS + s]) continue;
    const long long j = ring[c * NS + s];
    T xj[D];
#pragma unroll
    for (int k = 0; k < D; ++k) xj[k] = x[k * nc + j];
    const T* b = blocks + (long long)s * D * D * nc + c;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        acc[i] += b[(i * D + k) * nc] * xj[k];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) y[i * nc + c] = acc[i];
}

template <typename T>
int launch(const T* blocks, const T* x, const int* ring,
           const unsigned char* valid, T* y, long long nc,
           cudaStream_t stream) {
  const long long grid = (nc + THREADS - 1) / THREADS;
  ring_mv_kernel<T><<<(unsigned int)grid, THREADS, 0, stream>>>(
      blocks, x, ring, valid, y, nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
int ring_mv_f32(const float* blocks, const float* x, const int* ring,
                const unsigned char* valid, float* y, long long nc,
                cudaStream_t stream) {
  return launch<float>(blocks, x, ring, valid, y, nc, stream);
}

int ring_mv_f64(const double* blocks, const double* x, const int* ring,
                const unsigned char* valid, double* y, long long nc,
                cudaStream_t stream) {
  return launch<double>(blocks, x, ring, valid, y, nc, stream);
}

}  // extern "C"
