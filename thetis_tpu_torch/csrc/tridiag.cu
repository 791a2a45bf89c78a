// Batched tridiagonal (Thomas) solve for Hopper (sm_90a).
//
// Replaces thetis_tpu/kernels/tridiag.py::_thomas_kernel (the Pallas TPU
// kernel behind _pallas_thomas / tridiag_solve), which every implicit
// vertical column solve of the 3D step reaches: the vertical viscosity of
// both velocity components and the vertical diffusion of the tracers.
//
//   dl[i] x[i-1] + dd[i] x[i] + du[i] x[i+1] = rhs[i],  i = 0..n-1
//
// for bc independent columns.  The coefficients dl, dd, du are (bc, n)
// row-major (each column's n values contiguous; dl[0] and du[n-1] are
// ignored); rhs and x are (R, bc, n): R right-hand sides share one set of
// coefficients (R = 2 for the two velocity components, R = 1 for a
// tracer).  The recurrence is the reference's _thomas_scan one, two
// divisions a row, with each multiply-subtract pair written as one fused
// multiply-add; the tiled and the general kernel do the same arithmetic,
// and a column's result does not depend on R.
//
// Bound: device-memory bytes.  Each operand is read once and x written
// once: (3 + 2 R) n bc sizeof(T) bytes for ~8 n operations a column and
// right-hand side, nothing reused.  In f32 at n = 13: R = 1, bc = 27,648:
// 7.19 MB, 2.15 us at 3.35 TB/s; bc = 13,824: 3.59 MB, 1.07 us; the
// velocity solve, R = 2, bc = 13,824: 5.03 MB, 1.50 us.  Tensor cores and
// TMA have nothing to do here; what counts is coalescing, loads in flight
// and not moving a byte twice.  The measured times stand beside these
// bounds in PERF.md.
//
// Tiled kernel (tridiag_tile_kernel), taken while a tile of 8 columns fits
// in the 227 KB of shared memory a block may have:
//  * A block owns `cols` consecutive columns.  In (bc, n) storage that is
//    one contiguous run of cols * n elements of each operand, which the
//    block's 128 threads copy to shared memory with cp.async, 16 bytes a
//    thread on neighbouring addresses where the run starts on a 16-byte
//    boundary and the tile is not padded (element by element otherwise and
//    at a ragged end), all operands in flight before any arithmetic.
//  * One thread per column then sweeps out of shared memory at
//    col * stride + i; stride is n for odd n and n + 1 for even n, so a
//    warp's 32 columns fall in 32 different banks.  Each row's operands
//    are read one iteration ahead of the recurrence's divisions.
//  * The forward sweep overwrites the du and rhs slots with cp and dp (and
//    dd with the pivots), the back substitution overwrites dp with x, and
//    the block stores the x tile coalesced.  Nothing but the operands and
//    the result crosses device memory.
//  * The coefficients are read and eliminated once for all R right-hand
//    sides, which go through the tile's RR right-hand-side slots in
//    groups (RR = 2 for even R, else 1); groups after the first reuse the
//    stored pivots.
//  The geometry (cols of 64, 32, 16 or 8, the widest that fits; stride;
//  RR; threads; shared bytes; grid) is computed by the Python wrapper
//  (kernels/tridiag.py::tile_geometry) and checked here.  At n = 13 a call
//  is latency, not traffic: one 64-column tile alone takes nearly as long
//  as 432 of them (PERF.md).
//
// General kernel (tridiag_general_kernel), for longer columns: from
// n = 1816 in f32 and n = 908 in f64 (R odd; from n = 1452 and n = 726
// for even R).  One thread per column reads and writes device memory
// directly and keeps cp in a scratch buffer that the wrapper allocates;
// any n, any R (the elimination is repeated for each right-hand side).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GENERAL_THREADS = 64;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

__device__ __forceinline__ float fmad(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmad(double a, double b, double c) {
  return fma(a, b, c);
}

// whether a run starting at g can move as 16-byte vectors into or out of
// a tile (the tile's own start is 16-byte aligned)
template <typename T>
__device__ __forceinline__ bool vector_ok(const T* g, int n, int stride) {
  return stride == n && reinterpret_cast<uintptr_t>(g) % 16 == 0;
}

// f(e, slot) for this thread's share of the elements first <= e < len of a
// tile: e counts (column, row) with n rows a column, as device memory
// stores them; slot is the element's place in the tile, `stride` words a
// column.  One division a thread, none in the loop.
template <typename F>
__device__ __forceinline__ void for_each_slot(int first, int len, int n,
                                              int stride, F f) {
  int e = first + threadIdx.x;
  if (stride == n) {
    for (; e < len; e += blockDim.x) f(e, e);
    return;
  }
  int col = e / n;
  int row = e - col * n;
  const int dcol = blockDim.x / n;
  const int drow = blockDim.x - dcol * n;
  for (; e < len; e += blockDim.x) {
    f(e, col * stride + row);
    col += dcol;
    row += drow;
    if (row >= n) {
      row -= n;
      ++col;
    }
  }
}

// start the asynchronous copy of len = columns * n contiguous elements at
// g into the tile s
template <typename T>
__device__ __forceinline__ void load_tile(T* s, const T* g, int len, int n,
                                          int stride) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = vector_ok(g, n, stride) ? len / V : 0;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x)
    __pipeline_memcpy_async(s + v * V, g + v * V, 16);
  for_each_slot(nvec * V, len, n, stride, [&](int e, int at) {
    __pipeline_memcpy_async(s + at, g + e, sizeof(T));
  });
}

template <typename T>
__device__ __forceinline__ void store_tile(T* g, const T* s, int len, int n,
                                           int stride) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = vector_ok(g, n, stride) ? len / V : 0;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x)
    reinterpret_cast<int4*>(g)[v] = reinterpret_cast<const int4*>(s)[v];
  for_each_slot(nvec * V, len, n, stride,
                [&](int e, int at) { g[e] = s[at]; });
}

template <typename T, int RR>
__global__ void tridiag_tile_kernel(const T* __restrict__ dl,
                                    const T* __restrict__ dd,
                                    const T* __restrict__ du,
                                    const T* __restrict__ rhs,
                                    T* __restrict__ x, long long bc, int n,
                                    int R, int cols, int stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long col0 = (long long)blockIdx.x * cols;
  const long long left = bc - col0;
  const int here = left < cols ? (int)left : cols;
  const int len = here * n;
  const int tile = cols * stride;
  const long long g0 = col0 * n;
  T* s_dl = reinterpret_cast<T*>(smem_raw);
  T* s_dd = s_dl + tile;
  T* s_du = s_dd + tile;
  T* s_rhs = s_du + tile;  // RR tiles
  load_tile(s_dl, dl + g0, len, n, stride);
  load_tile(s_dd, dd + g0, len, n, stride);
  load_tile(s_du, du + g0, len, n, stride);
  const int o = threadIdx.x * stride;
  for (int r0 = 0; r0 < R; r0 += RR) {
#pragma unroll
    for (int k = 0; k < RR; ++k)
      load_tile(s_rhs + k * tile, rhs + (long long)(r0 + k) * bc * n + g0, len,
                n, stride);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (threadIdx.x < here) {
      // Each row's operands are read one iteration ahead, before the
      // current row's results are stored: the compiler cannot move a
      // shared-memory load over a store that may alias it, and the loads
      // would otherwise queue behind the divisions of the recurrence.
      const bool first = r0 == 0;  // later groups find pivots in the dd slot
      T l = s_dl[o], d = s_dd[o], u = s_du[o], b[RR], dp[RR];
#pragma unroll
      for (int k = 0; k < RR; ++k) {
        b[k] = s_rhs[k * tile + o];
        dp[k] = T(0);
      }
      T cp = T(0);
      for (int i = 0; i < n; ++i) {
        const int nx = o + (i + 1 < n ? i + 1 : i);
        const T l_nx = s_dl[nx], d_nx = s_dd[nx], u_nx = s_du[nx];
        T b_nx[RR];
#pragma unroll
        for (int k = 0; k < RR; ++k) b_nx[k] = s_rhs[k * tile + nx];
        const T m = first ? fmad(-l, cp, d) : d;
        if (first) {
          cp = u / m;
          s_du[o + i] = cp;
          s_dd[o + i] = m;
        }
#pragma unroll
        for (int k = 0; k < RR; ++k) {
          dp[k] = fmad(-l, dp[k], b[k]) / m;
          s_rhs[k * tile + o + i] = dp[k];
          b[k] = b_nx[k];
        }
        l = l_nx;
        d = d_nx;
        u = u_nx;
      }
      // row n - 1: x = dp, already in its slot; the rows above, read one
      // iteration ahead as in the forward sweep
      T c = s_du[o + (n > 1 ? n - 2 : 0)];
#pragma unroll
      for (int k = 0; k < RR; ++k)
        b[k] = s_rhs[k * tile + o + (n > 1 ? n - 2 : 0)];
      for (int i = n - 2; i >= 0; --i) {
        const int nx = o + (i > 0 ? i - 1 : 0);
        const T c_nx = s_du[nx];
        T b_nx[RR];
#pragma unroll
        for (int k = 0; k < RR; ++k) b_nx[k] = s_rhs[k * tile + nx];
#pragma unroll
        for (int k = 0; k < RR; ++k) {
          dp[k] = fmad(-c, dp[k], b[k]);
          s_rhs[k * tile + o + i] = dp[k];
          b[k] = b_nx[k];
        }
        c = c_nx;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RR; ++k)
      store_tile(x + (long long)(r0 + k) * bc * n + g0, s_rhs + k * tile, len,
                 n, stride);
    if (r0 + RR < R) __syncthreads();  // the next group reuses the slots
  }
}

template <typename T>
__global__ void __launch_bounds__(GENERAL_THREADS)
tridiag_general_kernel(const T* __restrict__ dl, const T* __restrict__ dd,
                       const T* __restrict__ du, const T* __restrict__ rhs,
                       T* __restrict__ x, T* __restrict__ cp, long long bc,
                       int n, int R) {
  const long long col = (long long)blockIdx.x * GENERAL_THREADS + threadIdx.x;
  if (col >= bc) return;
  const long long o = col * n;
  for (int r = 0; r < R; ++r) {
    const long long ro = ((long long)r * bc + col) * n;
    T c_prev = T(0);
    T d_prev = T(0);
    for (int i = 0; i < n; ++i) {
      const T l = dl[o + i];
      const T m = fmad(-l, c_prev, dd[o + i]);
      c_prev = du[o + i] / m;
      d_prev = fmad(-l, d_prev, rhs[ro + i]) / m;
      cp[o + i] = c_prev;
      x[ro + i] = d_prev;
    }
    T x_next = T(0);
    for (int i = n - 1; i >= 0; --i) {
      x_next = fmad(-cp[o + i], x_next, x[ro + i]);
      x[ro + i] = x_next;
    }
  }
}

template <typename T>
int launch_tile(const T* dl, const T* dd, const T* du, const T* rhs, T* x,
                long long bc, int n, int R, int rr, int cols, int stride,
                int threads, int smem, int grid, cudaStream_t stream) {
  if ((rr != 1 && rr != 2) || R % rr != 0 || stride < n || cols % 4 != 0 ||
      threads < cols || threads > 1024 ||
      grid < 1 || (long long)grid * cols < bc ||
      (long long)smem !=
          (long long)(3 + rr) * cols * stride * (long long)sizeof(T))
    return (int)cudaErrorInvalidValue;
  auto kernel = rr == 2 ? tridiag_tile_kernel<T, 2> : tridiag_tile_kernel<T, 1>;
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(dl, dd, du, rhs, x, bc, n, R, cols,
                                          stride);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_general(const T* dl, const T* dd, const T* du, const T* rhs, T* x,
                   T* cp, long long bc, int n, int R, cudaStream_t stream) {
  const long long grid = (bc + GENERAL_THREADS - 1) / GENERAL_THREADS;
  tridiag_general_kernel<T><<<(unsigned int)grid, GENERAL_THREADS, 0, stream>>>(
      dl, dd, du, rhs, x, cp, bc, n, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronise, and returns the CUDA error code of the
// launch (0: none).  dl, dd, du: (bc, n); rhs, x: (R, bc, n); contiguous.
int tridiag_tile_f32(const float* dl, const float* dd, const float* du,
                     const float* rhs, float* x, long long bc, int n, int R,
                     int rr, int cols, int stride, int threads, int smem,
                     int grid, cudaStream_t stream) {
  return launch_tile<float>(dl, dd, du, rhs, x, bc, n, R, rr, cols, stride,
                            threads, smem, grid, stream);
}

int tridiag_tile_f64(const double* dl, const double* dd, const double* du,
                     const double* rhs, double* x, long long bc, int n, int R,
                     int rr, int cols, int stride, int threads, int smem,
                     int grid, cudaStream_t stream) {
  return launch_tile<double>(dl, dd, du, rhs, x, bc, n, R, rr, cols, stride,
                             threads, smem, grid, stream);
}

// cp: scratch of (bc, n)
int tridiag_general_f32(const float* dl, const float* dd, const float* du,
                        const float* rhs, float* x, float* cp, long long bc,
                        int n, int R, cudaStream_t stream) {
  return launch_general<float>(dl, dd, du, rhs, x, cp, bc, n, R, stream);
}

int tridiag_general_f64(const double* dl, const double* dd, const double* du,
                        const double* rhs, double* x, double* cp, long long bc,
                        int n, int R, cudaStream_t stream) {
  return launch_general<double>(dl, dd, du, rhs, x, cp, bc, n, R, stream);
}

}  // extern "C"
