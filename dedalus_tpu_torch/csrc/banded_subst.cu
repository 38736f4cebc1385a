// Banded substitution kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// dedalus_tpu/core/fusedstep.py:520 pallas_substitution (pl.pallas_call at
// :585), called from dedalus_tpu/libraries/pencilops.py:1218-1222
// _solve_core. It solves B~ y = f, one right-hand side per thread block,
// against the per-block-row GEMM operators precomposed at factor time
// (dedalus_tpu_torch/libraries/pencilops.py BandedOps._precompose_subst):
//
//   forward:  [y_i; w] = FwdOp_i (2q x 2q) @ [w; f_{i+1}]      i < NB-1
//   last:     x_{NB-1} = lastOp (q x q) @ w
//   backward: x_i = BwdOp_i (q x 3q) @ [y_i; x_{i+1}; x_{i+2}]
//
// Layouts (all row-major, contiguous):
//   fwd  (NB-1, G, 2q, 2q)   bwd (NB-1, G, q, 3q)   last (G, q, q)
//   fp   (G, ncols, NB*q)    out (G, ncols, NB*q)
// ncols > 1 solves several independent right-hand sides per group (the
// factor-time Woodbury solve); the step-time solves have ncols = 1.
//
// Design. One thread block per (group, column); the NB-1 forward steps and
// NB-1 backward steps run in order inside the block (they are a chain of
// dependent matvecs). Each warp computes whole rows of the current operator:
// its lanes read the row's consecutive entries (coalesced) against the
// working vector in shared memory and reduce with warp shuffles. The
// working vectors [w; f_{i+1}] and [y_i; x_{i+1}; x_{i+2}] live in shared
// memory. y_i is stored in slot i of the block's own output row; the
// backward sweep reads it back, then overwrites slot i with x_i, so the
// block needs only O(q) shared memory for any NB (NB = 257 at the
// 2048 x 1024 Rayleigh-Benard size). The kernel allocates nothing and runs
// on the caller's stream.
//
// Bound. Bytes: every solve reads each operator word once, G*(NB-1)*7q^2
// words (117 MB in f64 at RB 256x64: G=128, NB=17, q=32; 15.0 GB at RB
// 2048x1024: G=1024, NB=257), i.e. ~35 us and ~4.5 ms at the H100's
// 3.35 TB/s; the 2 flops per word are negligible. This first kernel is
// latency-bound instead: each step waits for its operator's loads before
// the next can start, and only one block per right-hand side walks the
// chain. A faster design (later work) would prefetch operator i+1 into
// shared memory with cp.async/TMA while step i computes, give each block
// several groups so that more loads are in flight per SM, and read the
// operators in a group-major layout so one block streams one contiguous
// slab.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// res[r] = sum_c A[r * cols + c] * x[c] for r < rows; one warp per row.
template <typename T>
__device__ __forceinline__ void block_matvec(const T* __restrict__ A, const T* x,
                                             T* res, int rows, int cols) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    const T* row = A + static_cast<size_t>(r) * cols;
    T acc = T(0);
    for (int c = lane; c < cols; c += 32) acc += row[c] * x[c];
    acc = warp_sum(acc);
    if (lane == 0) res[r] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_subst_kernel(const T* __restrict__ fwd, const T* __restrict__ bwd,
                    const T* __restrict__ last, const T* __restrict__ fp,
                    T* __restrict__ out, int G, int ncols, int NB, int q) {
  extern __shared__ unsigned char smem_raw[];
  T* wf = reinterpret_cast<T*>(smem_raw);  // [w; f_{i+1}]            2q
  T* z = wf + 2 * q;                       // [y_i; x_{i+1}; x_{i+2}] 3q
  T* res = z + 3 * q;                      // matvec results          2q

  const int g = blockIdx.x / ncols;
  const size_t n_pad = static_cast<size_t>(NB) * q;
  const T* f = fp + static_cast<size_t>(blockIdx.x) * n_pad;
  T* y = out + static_cast<size_t>(blockIdx.x) * n_pad;
  const size_t fwd_stride = static_cast<size_t>(G) * 4 * q * q;
  const size_t bwd_stride = static_cast<size_t>(G) * 3 * q * q;

  for (int r = threadIdx.x; r < 2 * q; r += blockDim.x) wf[r] = f[r];
  __syncthreads();

  // forward sweep
  for (int i = 0; i < NB - 1; ++i) {
    block_matvec(fwd + i * fwd_stride + static_cast<size_t>(g) * 4 * q * q,
                 wf, res, 2 * q, 2 * q);
    __syncthreads();
    for (int r = threadIdx.x; r < q; r += blockDim.x) {
      y[static_cast<size_t>(i) * q + r] = res[r];            // y_i
      wf[r] = res[q + r];                                    // w
      wf[q + r] = (i + 2 < NB) ? f[static_cast<size_t>(i + 2) * q + r] : T(0);
    }
    __syncthreads();
  }

  // last block
  block_matvec(last + static_cast<size_t>(g) * q * q, wf, res, q, q);
  __syncthreads();
  for (int r = threadIdx.x; r < q; r += blockDim.x) {
    y[static_cast<size_t>(NB - 1) * q + r] = res[r];
    z[r] = y[static_cast<size_t>(NB - 2) * q + r];           // y_{NB-2}
    z[q + r] = res[r];                                       // x_{i+1}
    z[2 * q + r] = T(0);                                     // x_{i+2}
  }
  __syncthreads();

  // backward sweep
  for (int i = NB - 2; i >= 0; --i) {
    block_matvec(bwd + i * bwd_stride + static_cast<size_t>(g) * 3 * q * q,
                 z, res, q, 3 * q);
    __syncthreads();
    for (int r = threadIdx.x; r < q; r += blockDim.x) {
      const T x = res[r];
      y[static_cast<size_t>(i) * q + r] = x;                  // x_i
      z[2 * q + r] = z[q + r];
      z[q + r] = x;
      if (i > 0) z[r] = y[static_cast<size_t>(i - 1) * q + r];  // y_{i-1}
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* fwd, const T* bwd, const T* last, const T* fp, T* out,
           int G, int ncols, int NB, int q, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(7) * q * sizeof(T);
  banded_subst_kernel<T><<<G * ncols, kThreads, smem, stream>>>(
      fwd, bwd, last, fp, out, G, ncols, NB, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int banded_subst_f64(const double* fwd, const double* bwd, const double* last,
                     const double* fp, double* out, int G, int ncols, int NB,
                     int q, void* stream) {
  return launch<double>(fwd, bwd, last, fp, out, G, ncols, NB, q,
                        static_cast<cudaStream_t>(stream));
}

int banded_subst_f32(const float* fwd, const float* bwd, const float* last,
                     const float* fp, float* out, int G, int ncols, int NB,
                     int q, void* stream) {
  return launch<float>(fwd, bwd, last, fp, out, G, ncols, NB, q,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
