// Banded substitution kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// dedalus_tpu/core/fusedstep.py:520 pallas_substitution (pl.pallas_call at
// :585), called from dedalus_tpu/libraries/pencilops.py:1218-1222
// _solve_core. It solves B~ y = f for k right-hand sides per pencil group
// against the per-block-row GEMM operators precomposed at factor time
// (dedalus_tpu_torch/libraries/pencilops.py BandedOps._precompose_subst):
//
//   forward:  [y_i; w] = FwdOp_i (2q x 2q) @ [w; f_{i+1}]      i < NB-1
//   last:     x_{NB-1} = lastOp (q x q) @ w
//   backward: x_i = BwdOp_i (q x 3q) @ [y_i; x_{i+1}; x_{i+2}]
//
// Element types: double, float, and complex<double> / complex<float> as
// interleaved (re, im) pairs (torch's complex128 / complex64 layout): the
// same grid, ring and chain, each operator word twice as wide and each
// multiply-add a complex one (4 real FMAs).
//
// Layouts (all row-major, contiguous):
//   fwd  (NB-1, G, 2q, 2q)   bwd (NB-1, G, q, 3q)   last (G, q, q)
//   fp   (G, k, NB*q)        out (G, k, NB*q)
// k = 1 for the step-time solves; k = t (16 pins at Rayleigh-Benard) for
// the factor-time Woodbury solve.
//
// Bound. The work is bytes: each operator word is read once per solve
// and takes 2k flops, so at k = 1 it is 0.25 flop/byte in f64 and at
// k = 16 4 flop/byte, both far below the H100's f64 ridge (~10 flop/byte
// at 34 TFLOP/s and 3.35 TB/s). The least time is the operator bytes
// G*(NB-1)*7q^2 + G*q^2 words, plus fp read once and out written once,
// over the memory rate: at RB 2048x1024 (G=1024, NB=257, q=32, f64)
// 15.2 GB, 4.53 ms at 3.35 TB/s (H100 SXM data sheet); at RB 256x64
// (G=128, NB=17) 120 MB, 36 us.
//
// Design.
// - One thread block per pencil group, serving up to kMaxCols = 16 of its
//   columns, so each operator is read from device memory once per solve
//   for k <= 16 (a larger k takes ceil(k/16) blocks per group).
// - The block walks the chain of 2*NB-1 operators (FwdOp_0..FwdOp_{NB-2},
//   lastOp, BwdOp_{NB-2}..BwdOp_0). Every operator address is known
//   before the sweep starts, so one producer warp streams them ahead of
//   the chain into a ring of shared-memory stages with 1-D bulk copies
//   (cp.async.bulk, no tensor map), each completing on the stage's "full"
//   mbarrier. The unit of the ring is a row panel of at most panel_bytes
//   (32, 16 or 8 KB: the largest that leaves four stages), not a whole
//   operator, so a FwdOp of q = 128 (512 KB in f64) streams through it,
//   a panel need not hold a whole number of operators (q = 80 in f64:
//   25 rows of 1,280 bytes, and a last panel of 10), and at q = 32
//   several operators are in flight. The prefetch runs straight from the
//   forward sweep into the backward one. q <= kMaxQ = 128.
// - Eight consumer warps wait on a stage's "full" barrier, compute its
//   rows, and release it on its "empty" barrier (one arrive per warp).
//   A block alone on its SM (G <= 132) is bound by the chain's latency:
//   at k = 1 each row of a panel takes a power-of-two share of the 256
//   consumer threads, which sum strided columns of it (each warp's rows
//   rotated across the banks) and reduce in a few shuffle rounds, so a
//   panel is one short pass. Blocks that share an SM hide each other's
//   latency, and there a warp computes whole rows (four at k = 1, one
//   against 16 columns at k > 1; a butterfly reduction hands each lane
//   pair one column's sum), which takes fewer instructions per entry.
// - The chain state stays in shared memory: the working vectors
//   [w; f_{i+1}] and [y_i; x_{i+1}; x_{i+2}] (k columns each, double
//   buffered so that each operator costs one consumer barrier). The parts
//   of the next working vector that do not depend on the chain (f_{i+2},
//   y_{i-1}) are loaded into registers before the operator's panels and
//   stored after them. y_0..y_{NB-1} stay in shared memory when they take
//   at most kYSmemMax bytes; else they are parked in the block's own
//   output rows (read back one operator ahead, then overwritten by x_i).
// - A panel whose global address or size is not a multiple of 16 bytes
//   (odd q: a BwdOp slab of 3q^2 words, a lastOp of q^2 f32 words) is
//   copied by the producer warp with plain loads and stores instead.
// - The ring is sized from the shared memory a block may take at the
//   blocks per SM this launch aims at: 1 when G <= 132 (the block has
//   the SM to itself), up to 4 (k = 1) or 2 (k > 1) for larger G, fewer
//   where the working vectors would leave the ring under four stages
//   (k = 16 at large q: 2 x 3q x 16 words, 60 KB at q = 80 in f64).
// - CUDA cores and FMAs only: f64 has no wgmma, and the math is far below
//   the ridge. The kernel allocates nothing and runs on the caller's
//   stream; every entry point returns the CUDA error code.
//
// Registers, shared memory and spills of each instantiation <T, k tile,
// q range> (nvcc -Xptxas -v, CUDA 12.8, sm_90a; the build writes them to
// the .ptxas.txt file beside the library):
//   <double|float|complex<float>, 1, 128>   56 registers, 0 spills
//   <double|float|complex<float>, 16, 64>   96 registers, 0 spills
//   <double|float|complex<float>, 16, 128>  96 registers, 0 spills
//   <complex<double>, 1, 128>    56 registers, 76 bytes of spill stores
//   <complex<double>, 16, 64>    96 registers, 312 bytes of spill stores
//   <complex<double>, 16, 128>   96 registers, 604 bytes of spill stores
// all with 2 named barriers and no static shared memory; the dynamic
// shared memory (ring + vectors + y) is set per launch, up to 227 KB.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

// A complex number as torch stores it: (re, im) interleaved, aligned to
// its size so a row of them is a plain array for the bulk copies.
template <typename R>
struct alignas(2 * sizeof(R)) Cplx {
  R re, im;
  Cplx() = default;
  __device__ __forceinline__ Cplx(R r) : re(r), im(R(0)) {}
  __device__ __forceinline__ Cplx(R r, R i) : re(r), im(i) {}
};

template <typename R>
__device__ __forceinline__ Cplx<R> operator+(Cplx<R> a, Cplx<R> b) {
  return {a.re + b.re, a.im + b.im};
}

template <typename R>
__device__ __forceinline__ Cplx<R>& operator+=(Cplx<R>& a, Cplx<R> b) {
  a.re += b.re;
  a.im += b.im;
  return a;
}

template <typename R>
__device__ __forceinline__ Cplx<R> operator*(Cplx<R> a, Cplx<R> b) {
  return {fma(a.re, b.re, -a.im * b.im), fma(a.re, b.im, a.im * b.re)};
}

template <typename T>
__device__ __forceinline__ T shfl_xor(T v, int b) {
  return __shfl_xor_sync(0xffffffffu, v, b);
}

template <typename R>
__device__ __forceinline__ Cplx<R> shfl_xor(Cplx<R> v, int b) {
  return {__shfl_xor_sync(0xffffffffu, v.re, b),
          __shfl_xor_sync(0xffffffffu, v.im, b)};
}

constexpr int kConsumerWarps = 8;
constexpr int kConsumerThreads = 32 * kConsumerWarps;
constexpr int kThreads = kConsumerThreads + 32;  // + one producer warp
constexpr int kMaxStages = 32;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;  // full + empty mbarriers
constexpr int kMaxCols = 16;
// the largest block size q; the consumers' per-thread register share of
// the chain-independent part of a working vector is sized per q range
// (kSmallQ or kMaxQ) so that q <= kSmallQ keeps its registers
constexpr int kMaxQ = 128;
constexpr int kSmallQ = 64;
constexpr int kYSmemMax = 32 * 1024;
constexpr int kMaxDevices = 64;
constexpr int kMinPanelBytes = 8192;
// a ring stage holds at least one row of the widest operator (BwdOp, 3q
// words) of the widest element type (complex<double>)
static_assert(3 * kMaxQ * 16 <= kMinPanelBytes, "panel smaller than a row");

template <typename T>
struct Params {
  const T* fwd;
  const T* bwd;
  const T* last;
  const T* fp;
  T* out;
  int G, ncols, NB, q;
  int kc;           // columns per block
  int stages;       // ring stages
  int panel_bytes;  // bytes of one ring stage
  int y_smem;       // y_i kept in shared memory (else in the output rows)
  int split_rows;   // k = 1: panel_matvec_1 (else a warp per row)
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// 1-D bulk copy global -> shared, completing on `bar` (16-byte aligned
// addresses, size a multiple of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumerThreads) : "memory");
}

// ------------------------------------------------------- the operator chain

template <typename T>
struct Op {
  const T* A;
  int rows, cols;
};

// operator o of the chain: FwdOp_o (o < NB-1), lastOp (o == NB-1),
// BwdOp_{2(NB-1)-o} (o > NB-1)
template <typename T>
__device__ __forceinline__ Op<T> chain_op(const Params<T>& p, int g, int o) {
  const int q = p.q, NB = p.NB;
  if (o < NB - 1)
    return {p.fwd + (static_cast<size_t>(o) * p.G + g) * 4 * q * q, 2 * q,
            2 * q};
  if (o == NB - 1) return {p.last + static_cast<size_t>(g) * q * q, q, q};
  const int i = 2 * (NB - 1) - o;
  return {p.bwd + (static_cast<size_t>(i) * p.G + g) * 3 * q * q, q, 3 * q};
}

// The producer warp: stream every panel of the chain into the ring.
template <typename T>
__device__ void produce(const Params<T>& p, int g, T* ring, uint64_t* full,
                        uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  const int panel_elems = p.panel_bytes / static_cast<int>(sizeof(T));
  int stage = 0;
  uint32_t phase = 0;
  for (int o = 0; o < 2 * p.NB - 1; ++o) {
    const Op<T> op = chain_op(p, g, o);
    const int pr = min(op.rows, panel_elems / op.cols);
    for (int r0 = 0; r0 < op.rows; r0 += pr) {
      const int n = min(pr, op.rows - r0) * op.cols;
      const T* src = op.A + static_cast<size_t>(r0) * op.cols;
      T* dst = ring + static_cast<size_t>(stage) * panel_elems;
      const uint32_t bytes = n * sizeof(T);
      mbar_wait(&empty[stage], phase ^ 1);
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], bytes);
          bulk_load(dst, src, bytes, &full[stage]);
        }
      } else {
#pragma unroll 4
        for (int e = lane; e < n; e += 32) dst[e] = src[e];
        // order these generic-proxy writes before later bulk copies into
        // the same stage
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[stage]);
      }
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// Sum the KT per-lane partial sums of one row over the warp, leaving the
// full sum of column `col` in a[0] on every lane; lanes
// (lane & (32/KT - 1)) == 0 hold distinct columns. A butterfly: each
// exchange halves the values a lane keeps, so KT columns cost KT
// shuffles, not 5*KT.
template <int N, typename T>
struct ColumnReduce {
  static __device__ __forceinline__ void run(T* a, int lane, int b, int& col) {
    const bool up = lane & b;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const T send = up ? a[j] : a[j + N / 2];
      const T keep = up ? a[j + N / 2] : a[j];
      a[j] = keep + shfl_xor(send, b);
    }
    if (up) col += N / 2;
    ColumnReduce<N / 2, T>::run(a, lane, b >> 1, col);
  }
};

template <typename T>
struct ColumnReduce<1, T> {
  static __device__ __forceinline__ void run(T* a, int, int b, int&) {
    for (; b > 0; b >>= 1) a[0] += shfl_xor(a[0], b);
  }
};

// One column (k = 1): rows [0, rows) of one panel A (rows x cols,
// row-major) times v. Each row takes tpr consumer threads (a power of two,
// rows * tpr <= 256); thread s of a row sums the columns s + tpr*m with
// two accumulators, then the row reduces in log2(tpr) shuffle rounds.
// The rows of one warp start at different m, so that with cols a multiple
// of 16 the warp's reads of A and v fall in distinct banks (two
// wavefronts in f64). sink(panel_row0 + row, 0, value).
template <typename T, typename Sink>
__device__ __forceinline__ void panel_matvec_1(const T* A, int rows, int cols,
                                               const T* v, int panel_row0,
                                               int tid, Sink& sink) {
  int tpr = 32;
  while (tpr > 1 && rows * tpr > kConsumerThreads) tpr >>= 1;
  const int nseg = (cols + tpr - 1) / tpr;  // columns per thread
  const int row = tid / tpr, s = tid % tpr;
  T acc0 = T(0), acc1 = T(0);
  if (row < rows) {
    const T* a = A + row * cols;
    int m = ((tid & 31) / tpr) % nseg;
    for (int n = 0; n + 1 < nseg; n += 2) {
      const int c = s + tpr * m;
      if (++m == nseg) m = 0;
      const int d = s + tpr * m;
      if (++m == nseg) m = 0;
      if (c < cols) acc0 += a[c] * v[c];
      if (d < cols) acc1 += a[d] * v[d];
    }
    if (nseg & 1) {
      const int c = s + tpr * m;
      if (c < cols) acc0 += a[c] * v[c];
    }
  }
  acc0 += acc1;
  for (int b = tpr >> 1; b > 0; b >>= 1)
    acc0 += shfl_xor(acc0, b);
  if (row < rows && s == 0) sink(panel_row0 + row, 0, acc0);
}

// Rows [0, rows) of one panel A (rows x cols, row-major) times the KT
// working columns v[t * vstride + c], a warp per RB rows: its lanes read
// consecutive entries of A and v (conflict-free), and each row's KT
// partial sums are reduced by ColumnReduce; sink(panel_row0 + row, col,
// value) for col < ncol. Fewer instructions per entry than
// panel_matvec_1, for blocks that share their SM.
template <typename T, int KT, int RB, typename Sink>
__device__ __forceinline__ void panel_matvec(const T* A, int rows, int cols,
                                             const T* v, int vstride,
                                             int panel_row0, int ncol,
                                             int lane, int warp, Sink& sink) {
  for (int rb = warp * RB; rb < rows; rb += kConsumerWarps * RB) {
    T acc[RB][KT];
#pragma unroll
    for (int j = 0; j < RB; ++j)
#pragma unroll
      for (int t = 0; t < KT; ++t) acc[j][t] = T(0);
    for (int c = lane; c < cols; c += 32) {
      T a[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j)
        a[j] = rb + j < rows ? A[(rb + j) * cols + c] : T(0);
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const T x = v[t * vstride + c];
#pragma unroll
        for (int j = 0; j < RB; ++j) acc[j][t] += a[j] * x;
      }
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      int col = 0;
      ColumnReduce<KT, T>::run(acc[j], lane, 16, col);
      if (rb + j < rows && (lane & (32 / KT - 1)) == 0 && col < ncol)
        sink(panel_row0 + rb + j, col, acc[j][0]);
    }
  }
}

// The consumer warps: walk the chain, one operator at a time. MQ bounds q
// (kSmallQ or kMaxQ): it sizes PM, each thread's share of the q*KT words
// of a working vector that are loaded ahead of an operator.
template <typename T, int KT, int MQ>
__device__ void consume(const Params<T>& p, int g, const T* ring,
                        uint64_t* full, uint64_t* empty, T* vbuf, T* ysm) {
  constexpr int PM = (MQ * KT + kConsumerThreads - 1) / kConsumerThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = p.q, NB = p.NB, n_pad = NB * q, nops = 2 * NB - 1;
  const int col0 = blockIdx.y * p.kc;
  const int ncol = min(p.kc, p.ncols - col0);
  const int panel_elems = p.panel_bytes / static_cast<int>(sizeof(T));
  const size_t base = (static_cast<size_t>(g) * p.ncols + col0) * n_pad;
  const T* f = p.fp + base;  // column c at f[c * n_pad + ...]
  T* out = p.out + base;
  T* y = p.y_smem ? ysm : out;  // y_i of column c at y[c * n_pad + i*q]
  const int vlen = 3 * q * KT;
  T* vcur = vbuf;
  T* vnext = vbuf + vlen;

  for (int e = tid; e < 2 * vlen; e += kConsumerThreads) vbuf[e] = T(0);
  consumer_sync();
  for (int e = tid; e < 2 * q * ncol; e += kConsumerThreads) {
    const int c = e / (2 * q), r = e % (2 * q);
    vcur[c * 2 * q + r] = f[static_cast<size_t>(c) * n_pad + r];  // [f_0; f_1]
  }
  consumer_sync();

  int stage = 0;
  uint32_t phase = 0;
  for (int o = 0; o < nops; ++o) {
    const bool fwd = o < NB - 1, lastop = o == NB - 1;
    const int i = fwd ? o : (lastop ? NB - 1 : 2 * (NB - 1) - o);
    const int rows = fwd ? 2 * q : q;
    const int cols = fwd ? 2 * q : (lastop ? q : 3 * q);
    const int vin = fwd || lastop ? 2 * q : 3 * q;  // input column stride
    // the part of the next working vector that does not depend on the
    // chain: f_{i+2} (forward) or y_{i-1} (last, backward), loaded now,
    // stored after the operator's panels
    T pre[PM];
#pragma unroll
    for (int m = 0; m < PM; ++m) {
      const int e = tid + m * kConsumerThreads;
      pre[m] = T(0);
      if (e < q * ncol) {
        const size_t c = e / q, r = e % q;
        if (fwd) {
          if (i + 2 < NB) pre[m] = f[c * n_pad + (i + 2) * q + r];
        } else if (i > 0) {
          pre[m] = y[c * n_pad + (i - 1) * q + r];
        }
      }
    }

    auto sink = [&](int r, int c, T val) {
      if (fwd) {
        if (r < q) y[static_cast<size_t>(c) * n_pad + i * q + r] = val;  // y_i
        else vnext[c * 2 * q + r - q] = val;                             // w
      } else {
        out[static_cast<size_t>(c) * n_pad + i * q + r] = val;           // x_i
        vnext[c * 3 * q + q + r] = val;
      }
    };
    const int pr = min(rows, panel_elems / cols);
    for (int r0 = 0; r0 < rows; r0 += pr) {
      mbar_wait(&full[stage], phase);
      const T* A = ring + static_cast<size_t>(stage) * panel_elems;
      const int n = min(pr, rows - r0);
      if constexpr (KT == 1) {
        if (p.split_rows)
          panel_matvec_1(A, n, cols, vcur, r0, tid, sink);
        else
          panel_matvec<T, 1, 4>(A, n, cols, vcur, vin, r0, ncol, lane, warp,
                                sink);
      } else {
        panel_matvec<T, KT, 1>(A, n, cols, vcur, vin, r0, ncol, lane, warp,
                               sink);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int m = 0; m < PM; ++m) {
      const int e = tid + m * kConsumerThreads;
      if (e < q * ncol) {
        const int c = e / q, r = e % q;
        if (fwd) {
          vnext[c * 2 * q + q + r] = pre[m];                      // f_{i+2}
        } else {
          vnext[c * 3 * q + r] = pre[m];                          // y_{i-1}
          vnext[c * 3 * q + 2 * q + r] =
              lastop ? T(0) : vcur[c * 3 * q + q + r];            // x_{i+1}
        }
      }
    }
    consumer_sync();
    T* t = vcur;
    vcur = vnext;
    vnext = t;
  }
}

template <typename T, int KT, int MQ>
__global__ void __launch_bounds__(kThreads, KT == 1 ? 4 : 2)
banded_subst_kernel(const Params<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  T* ring = reinterpret_cast<T*>(smem + kBarrierBytes);
  T* vbuf = reinterpret_cast<T*>(smem + kBarrierBytes +
                                 static_cast<size_t>(p.stages) * p.panel_bytes);
  T* ysm = vbuf + 2 * 3 * p.q * KT;
  const int g = blockIdx.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumerThreads)
    produce(p, g, ring, full, empty);
  else
    consume<T, KT, MQ>(p, g, ring, full, empty, vbuf, ysm);
}

// ------------------------------------------------------------- host side

struct DeviceInfo {
  int sms, smem_per_sm, reserved, optin;
};

struct Plan {
  int kt, kc, grid_y, blocks_per_sm, stages, panel_bytes, smem_bytes, y_smem,
      split_rows;
};

std::mutex g_mutex;
bool g_have_info[kMaxDevices];
DeviceInfo g_info[kMaxDevices];

cudaError_t device_info(DeviceInfo* info) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!g_have_info[dev]) {
    DeviceInfo d;
    if ((err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &d.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
             dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &d.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess)
      return err;
    g_info[dev] = d;
    g_have_info[dev] = true;
  }
  *info = g_info[dev];
  return cudaSuccess;
}

// The launch shape: columns per block, the blocks per SM aimed at, and the
// ring (stages x panel bytes) that the shared memory left at that
// occupancy holds. Where the working vectors leave the ring fewer than
// four stages (large q at k > 1), fewer blocks share an SM; alone on its
// SM a block takes two stages or more.
cudaError_t make_plan(int G, int ncols, int NB, int q, int item,
                      const DeviceInfo& d, Plan* pl) {
  if (G < 1 || ncols < 1 || NB < 2 || q < 1 || q > kMaxQ)
    return cudaErrorInvalidValue;
  Plan p;
  p.kt = ncols == 1 ? 1 : kMaxCols;
  p.kc = ncols < kMaxCols ? ncols : kMaxCols;
  p.grid_y = (ncols + p.kc - 1) / p.kc;
  const int cap = p.kt == 1 ? 4 : 2;  // the kernels' __launch_bounds__
  const long long blocks = static_cast<long long>(G) * p.grid_y;
  long long bps = (blocks + d.sms - 1) / d.sms;
  bps = bps < 1 ? 1 : (bps > cap ? cap : bps);
  // barriers + working vectors
  const long long fixed = kBarrierBytes + 2LL * 3 * q * p.kt * item;
  const long long ybytes = static_cast<long long>(NB) * q * p.kc * item;
  long long stages;
  for (;; --bps) {
    long long budget = d.smem_per_sm / bps - d.reserved;
    if (budget > d.optin) budget = d.optin;
    budget &= ~15LL;
    p.y_smem = ybytes <= kYSmemMax && fixed + ybytes + 4 * 16384 <= budget;
    const long long ring = budget - fixed - (p.y_smem ? ybytes : 0);
    // the largest of 32, 16 and 8 KB that leaves at least four stages
    p.panel_bytes = 32768;
    while (p.panel_bytes > kMinPanelBytes && ring < 4LL * p.panel_bytes)
      p.panel_bytes >>= 1;
    stages = ring / p.panel_bytes;
    if (stages > kMaxStages) stages = kMaxStages;
    if (stages >= 4 || (bps == 1 && stages >= 2)) break;
    if (bps == 1) return cudaErrorInvalidConfiguration;
  }
  p.blocks_per_sm = static_cast<int>(bps);
  p.stages = static_cast<int>(stages);
  p.smem_bytes = static_cast<int>(fixed + (p.y_smem ? ybytes : 0) +
                                  stages * p.panel_bytes);
  // a block alone on its SM is bound by the chain's latency: split each
  // row over several threads; blocks that share an SM hide each other's
  // latency, and a warp per row takes fewer instructions
  p.split_rows = p.kt == 1 && p.blocks_per_sm == 1;
  *pl = p;
  return cudaSuccess;
}

template <typename T, int KT, int MQ>
cudaError_t launch_kt(const Params<T>& prm, const Plan& pl,
                      cudaStream_t stream) {
  static int set_bytes[kMaxDevices];  // dynamic smem allowed, per device
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (pl.smem_bytes > set_bytes[dev]) {
      err = cudaFuncSetAttribute(banded_subst_kernel<T, KT, MQ>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 pl.smem_bytes);
      if (err != cudaSuccess) return err;
      set_bytes[dev] = pl.smem_bytes;
    }
  }
  const dim3 grid(prm.G, pl.grid_y);
  banded_subst_kernel<T, KT, MQ>
      <<<grid, kThreads, pl.smem_bytes, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* fwd, const T* bwd, const T* last, const T* fp, T* out,
           int G, int ncols, int NB, int q, cudaStream_t stream) {
  DeviceInfo d;
  Plan pl;
  cudaError_t err = device_info(&d);
  if (err == cudaSuccess)
    err = make_plan(G, ncols, NB, q, static_cast<int>(sizeof(T)), d, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params<T> prm{fwd, bwd, last, fp, out, G, ncols, NB, q,
                      pl.kc, pl.stages, pl.panel_bytes, pl.y_smem,
                      pl.split_rows};
  // at k = 1 each thread holds one word of the q words whatever q (PM = 1)
  if (pl.kt == 1)
    err = launch_kt<T, 1, kMaxQ>(prm, pl, stream);
  else if (q <= kSmallQ)
    err = launch_kt<T, kMaxCols, kSmallQ>(prm, pl, stream);
  else
    err = launch_kt<T, kMaxCols, kMaxQ>(prm, pl, stream);
  return static_cast<int>(err);
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

// complex128 / complex64: interleaved (re, im) pairs
int banded_subst_c128(const void* fwd, const void* bwd, const void* last,
                      const void* fp, void* out, int G, int ncols, int NB,
                      int q, void* stream) {
  using C = Cplx<double>;
  return launch<C>(static_cast<const C*>(fwd), static_cast<const C*>(bwd),
                   static_cast<const C*>(last), static_cast<const C*>(fp),
                   static_cast<C*>(out), G, ncols, NB, q,
                   static_cast<cudaStream_t>(stream));
}

int banded_subst_c64(const void* fwd, const void* bwd, const void* last,
                     const void* fp, void* out, int G, int ncols, int NB,
                     int q, void* stream) {
  using C = Cplx<float>;
  return launch<C>(static_cast<const C*>(fwd), static_cast<const C*>(bwd),
                   static_cast<const C*>(last), static_cast<const C*>(fp),
                   static_cast<C*>(out), G, ncols, NB, q,
                   static_cast<cudaStream_t>(stream));
}

// The launch shape chosen for a solve on the current device, for reports:
// plan[0..8] = column tile (1 or 16), columns per block, blocks per
// group, blocks per SM aimed at, ring stages, panel bytes, dynamic shared
// memory bytes, y_i in shared memory (1) or in the output rows (0), rows
// split over threads (1) or a warp per row (0).
int banded_subst_plan(int G, int ncols, int NB, int q, int itemsize,
                      int* plan) {
  DeviceInfo d;
  Plan pl;
  cudaError_t err = device_info(&d);
  if (err == cudaSuccess) err = make_plan(G, ncols, NB, q, itemsize, d, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[9] = {pl.kt,     pl.kc,          pl.grid_y,
                    pl.blocks_per_sm, pl.stages, pl.panel_bytes,
                    pl.smem_bytes, pl.y_smem, pl.split_rows};
  for (int j = 0; j < 9; ++j) plan[j] = v[j];
  return 0;
}

}  // extern "C"
