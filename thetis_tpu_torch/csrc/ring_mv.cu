// Assembled 1-ring block matvec for Hopper (sm_90a).
//
// Replaces thetis_tpu/kernels/ringmv.py::_mv_kernel (the Pallas TPU
// kernel behind _mv_call / ring_mv_pallas, reached from
// ShiftStencil.apply_T).
//
//   y[i, c] = sum_{s valid} sum_k B[s, i, k, c] * x[k, ring[c, s]]
//
// blocks (NS=4, D=9, D=9, nc), x and y (D, nc), all component-major (cell
// index fastest); ring (nc, 4) int32, valid (nc, 4) bytes (0 = boundary
// mirror slot, skipped).  The TPU version pre-shifted the neighbour values
// in XLA (Mosaic cannot load lane-unaligned slices) and left the
// nonconforming rows to a separate correction; here the ring table drives
// the gather, so every mesh takes the same single launch.
//
// What bounds it.  Each block entry is read once for one multiply-add:
// 0.5 flop per byte in f32, against ~20 for the card's f32 units and ~295
// for its bf16 tensor cores, so the kernel is bound by moving the blocks
// (4*81*nc*sizeof(T) bytes, plus the vectors and tables).  At the 2D CN
// bench's nc = 102,400 that is 142 MB in f32 (42 us at 3.35 TB/s): device
// memory bandwidth.  At the 3D step's barotropic nc = 4,608 it is 6.4 MB,
// which stays in the 50 MB L2 across an FGMRES solve; there the time is
// the latency of a launch and of two dependent loads, so the grid must
// fill the card.  Tensor cores (wgmma) and TMA have nothing to do here:
// there is no reuse of a block entry to feed a matrix unit, and the
// per-thread loads below are already coalesced 128-byte rows.
//
// Design.  The earlier design ran one thread per cell (18 CTAs of 256 at
// nc 4,608: 18 of 132 SMs busy, each thread issuing 4 x 90 loads one slot
// after another; 11.1 us there and 55.7 us at nc 102,400 in f32 on an
// H100 80GB HBM3 at 700 W, where its note estimated "~44 us" from the
// blocks' bytes alone).  Now a CTA takes a tile of TC = 32 consecutive
// cells x 9 output rows, one thread per (cell, row), 288 threads = 9 full
// warps; warp i computes row i of the tile's 32 cells (144 CTAs at nc
// 4,608, 3,200 at nc 102,400; several fit on an SM, so the 144 run as one
// wave).  Each thread
//   1. reads its cell's 4 valid flags and issues its 36 block loads
//      B[s, i, k, c] at once (predicated on the slot being valid); for a
//      fixed (s, i, k) the warp's 32 cells are 32 consecutive values, so
//      every block read is one coalesced row;
//   2. gathers x[i, ring[c, s]] for the 4 slots into shared memory, so the
//      tile's 4 x 9 x 32 neighbour values are fetched once, not 9 times
//      (the [s][k][cell] layout makes both the stores and the reads below
//      conflict-free: a warp touches 32 consecutive words);
//   3. after one barrier, sums its row slot by slot and k by k, the
//      earlier design's order (so f64 stays at the plain version's
//      roundoff), and writes it.
// The block loads of step 1 are in flight while step 2's dependent
// ring -> x loads complete: the critical path is two load latencies.
// The last tile is masked (its missing cells load nothing and store
// nothing), a row whose slots are all invalid stores zero, and duplicate
// neighbours are summed as the plain version sums them.
#include <cuda_runtime.h>

namespace {

constexpr int NS = 4;
constexpr int D = 9;
constexpr int TC = 32;            // cells per tile (one warp's width)
constexpr int THREADS = TC * D;   // one thread per (cell, row)

template <typename T>
__global__ void __launch_bounds__(THREADS)
ring_mv_kernel(const T* __restrict__ blocks, const T* __restrict__ x,
               const int* __restrict__ ring,
               const unsigned char* __restrict__ valid,
               T* __restrict__ y, long long nc) {
  __shared__ T xs[NS][D][TC];
  const int lane = threadIdx.x % TC;
  const int i = threadIdx.x / TC;
  const long long c = (long long)blockIdx.x * TC + lane;
  const bool in = c < nc;
  bool v[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) v[s] = in && valid[c * NS + s];
  T b[NS][D];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const T* bs = blocks + ((long long)(s * D + i) * D) * nc + c;
#pragma unroll
    for (int k = 0; k < D; ++k) b[s][k] = v[s] ? bs[k * nc] : T(0);
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    xs[s][i][lane] = v[s] ? x[i * nc + ring[c * NS + s]] : T(0);
  }
  __syncthreads();
  if (!in) return;
  T acc = T(0);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (!v[s]) continue;
#pragma unroll
    for (int k = 0; k < D; ++k) acc += b[s][k] * xs[s][k][lane];
  }
  y[i * nc + c] = acc;
}

template <typename T>
int launch(const T* blocks, const T* x, const int* ring,
           const unsigned char* valid, T* y, long long nc,
           cudaStream_t stream) {
  const long long grid = (nc + TC - 1) / TC;
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
