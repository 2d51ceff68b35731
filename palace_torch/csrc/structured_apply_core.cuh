// The shared core of both structured-apply kernels (structured_apply.cu,
// natural channel order; structured_apply_v2.cu, carry-class channel
// order): the uniform box-hex Nedelec (ND) operator apply on the flattened
// padded lattice, as one output-stationary product on Hopper's float64
// tensor cores (DMMA, `mma.sync` .f64), written by hand for sm_90a.
//
// What it computes, per batch column b (the arithmetic of the Pallas
// kernels `_kernel` and `_kernel_v2`): for every local dof a (row of Af)
// with lattice channel chan[a] and flat offset off[a],
//     ul[k, q] = u[b, chan[k], off[k] + q]             q in [0, Lp)
//     y[b, chan[a], off[a] + q] += mask[q] * sum_k Af[a, k] ul[k, q],
// and every y position no local dof covers is 0.  The two layouts differ
// only in their tables (`core_tables` in ops/structured_kernel.py).
//
// Design.  One CTA owns the output tile y[b, :, m0 : m0 + kTile) of all C
// channels and writes it once, so there is no scratch tensor and no second
// pass.  The local dofs fall into a few flat-offset groups (7: offsets 0,
// 1, sy, sy+1, sx, sx+1, sx+sy), and the rows of group g with offset o_g
// contribute to output column m0 + t through the E-vector column
// q = m0 - o_g + t.  So the tile is a GEMM per group,
//     D_g[t, n] = sum_k W[k, t + s_g] Af[row_g(n), k],
// over a window W[k, j] = u[b, chan[k], off[k] + m0 - e_w + j] (zero where
// the column m0 - e_w + j lies outside [0, Lp)).  Groups whose offsets lie
// within kMaxShift columns read one window, each at its shift
// s_g = e_w - o_g, so a tile stages 2 windows of kTile + sy + 1 columns
// (offsets 0, 1, sy, sy+1 and sx, sx+1, sx+sy), not 7 of kTile.  The rows
// sit on the n8 side of the m16n8k8 tile, each group padded to a multiple
// of 8 rows (184 rows for nd = 144 at p = 3), and the columns t on the m16
// side.  Af and the windows are staged in k-chunks of kChunk rows with
// cp.async, kStages deep (chunk c + kStages - 1 is copied while chunk c is
// multiplied); the accumulators of all groups stay in registers through
// the k loop.  Then the warps store the tile's products D in shared memory
// (over the stages), and one thread per output y[b, ch, m0 + t] sums its
// channel's rows (at most four, in group order), each times its group's
// mask at that column (0 outside [0, Lp)), and writes it.  A CTA holds at
// most kPassNt n-tiles (192 rows: p <= 3 in one pass); above that the
// n-tiles are split into passes of equal size, each a k loop of its own
// over freshly staged windows, and a later pass adds its rows to the
// outputs the earlier ones wrote (the same thread, in the same row order,
// so the sum is the one-pass sum).  A tile that no group reaches is
// written as zeros and stages nothing.  No atomics: results are
// deterministic.
//
// What bounds it on the card: the useful work is 2 nd^2 per real cell and
// column (1.15 GFLOP at p = 3, 12^3, B = 16; 2.72 GFLOP at 16^3), and the
// compulsory traffic is one read of u and one write of y (25.2 MB each way
// at 12^3, 53.1 MB at 16^3), so it is bound by operations on the float64
// tensor cores.  The issued work adds the row padding (184 / 144) and the
// pad-plane columns; the window re-reads (each u element about 4 times)
// come from L2, which holds u at 12^3.  CTAs of one batch column run in
// column order, so neighbouring tiles share their window reads in L2.
// Measured on an H100 (PERF.md), the k-chunk copies and the per-tile fixed
// costs take most of a launch, not the DMMA product.
//
// float32 (no solver path runs it) uses the same tiles and the same
// ownership of the accumulators with an FMA product: TF32 tensor cores
// would keep about three digits.

#pragma once

#include <cuda_runtime.h>

// Internal linkage: each entry-point library holds its own instance of the
// core (a shared template instance would be one GNU-unique symbol across
// both libraries, with one launch-attribute cache for two kernels).
namespace palace_core {
namespace {

constexpr int kTile = 64;      // output columns per CTA
constexpr int kParts = 4;      // n-tile ranges: a warp owns one of them
constexpr int kWarps = 4 * kParts;  // 4 column tiles of 16 x kParts ranges
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;     // E-vector rows (k) per staged chunk
constexpr int kStep = 8;       // k of one m16n8k8 product
constexpr int kMaxNt = 6;      // n-tiles (8 rows) a warp accumulates
constexpr int kPassNt = kParts * kMaxNt;  // n-tiles of one pass
constexpr int kAfStride = kChunk + 4;  // = 4 mod 16: B fragments conflict-free
constexpr int kMaxShift = 32;  // a window feeds groups within 32 columns
constexpr int kWinStride = kTile + kMaxShift + 4;  // = 4 mod 16
constexpr int kDStride = kTile + 2;   // = 2 mod 16: D stores conflict-free
constexpr int kMaxA = 4;       // rows (contributions) of one channel

// Kernel arguments.  `tables` (int32) holds, one after the other:
//   src[nd]      chan[k] Lu + off[k]: where E-vector row k starts in u[b]
//   rowmap[nr]   the Af row of each padded row (-1: padding), by group
//   ntgroup[nt]  the group of each n-tile of 8 padded rows (nt = nr / 8)
//   goff[ng]     each group's flat offset
//   gwin[ng]     each group's window
//   gshift[ng]   each group's shift in its window, e_w - goff[g]
//   woff[nw]     each window's offset e_w (its groups' largest)
//   wspan[nw]    each window's largest shift (<= kMaxShift)
//   chanrows[C][kMaxA]  the padded rows of each channel, in group order
//                (-1 padded)
template <typename T>
struct Params {
  const T* Af;
  const T* u;
  const T* mask;
  T* y;
  const int* tables;
  int C, nd, Lp, Lu, nr, ng, nw;
};

template <typename T>
__host__ __device__ inline int table_size(const Params<T>& P) {
  return P.nd + P.nr + P.nr / 8 + 3 * P.ng + 2 * P.nw + kMaxA * P.C;
}

template <typename T>
__host__ __device__ inline size_t table_bytes(const Params<T>& P) {
  return ((sizeof(int) * table_size(P) + 15) / 16) * 16;
}

// Padded rows of the largest pass: the passes split the nr / 8 n-tiles
// into ceil(nr / 8 / kPassNt) ranges of equal size.
__host__ __device__ inline int pass_rows(int nr) {
  const int nt = nr / 8, npass = (nt + kPassNt - 1) / kPassNt;
  return 8 * ((nt + npass - 1) / npass);
}

__host__ __device__ inline size_t stage_elems(int nr, int nw) {
  return static_cast<size_t>(pass_rows(nr)) * kAfStride +
         static_cast<size_t>(nw) * kChunk * kWinStride;
}

// Shared memory: the tables, the mask of each group over the tile, then
// `stages` chunks (after a pass's k loop: the pass's products D).
template <typename T>
inline size_t smem_bytes(const Params<T>& P, int stages_n) {
  const size_t stages = stages_n * stage_elems(P.nr, P.nw);
  const size_t dtile = static_cast<size_t>(pass_rows(P.nr)) * kDStride;
  return table_bytes(P) +
         sizeof(T) * (P.ng * kTile + (stages > dtile ? stages : dtile));
}

// N elements copied global -> shared asynchronously, or zero-filled when
// `ok` is false (the source is then not read).
template <int N, typename T>
__device__ inline void copy_or_zero(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N * sizeof(T)), "r"(ok ? int(N * sizeof(T)) : 0));
}

__device__ inline void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N copy groups are in flight.
template <int N>
__device__ inline void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The A fragment of one k-step (A[t, k] = W[k, t]: the window transposed)
// and the product of one n-tile.  `W` points at window row ks, column
// 16 * (column tile) + shift; `B` at padded row 8 * (n-tile), column ks of
// the staged Af chunk.  Accumulator element i of a lane (gid = lane / 4,
// tig = lane % 4) is D[t, n] with t = gid + 8 (i / 2), n = 2 tig + i % 2,
// for both types.
template <typename T>
struct Frag;

template <>
struct Frag<double> {
  // m16n8k8 .f64: a_i = A[gid + 8 (i % 2), tig + 4 (i / 2)];
  // b_i = B[tig + 4 i, gid].
  double a[4];

  __device__ void load(const double* W, int gid, int tig) {
    a[0] = W[tig * kWinStride + gid];
    a[1] = W[tig * kWinStride + gid + 8];
    a[2] = W[(tig + 4) * kWinStride + gid];
    a[3] = W[(tig + 4) * kWinStride + gid + 8];
  }

  __device__ void mma(double (&d)[4], const double* B, int gid,
                      int tig) const {
    const double* Bp = B + gid * kAfStride;
    const double b0 = Bp[tig], b1 = Bp[tig + 4];
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
  }
};

template <>
struct Frag<float> {
  float a[2][kStep];  // W[ks + k, t] for t = gid, gid + 8

  __device__ void load(const float* W, int gid, int tig) {
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      a[0][k] = W[k * kWinStride + gid];
      a[1][k] = W[k * kWinStride + gid + 8];
    }
  }

  __device__ void mma(float (&d)[4], const float* B, int gid, int tig) const {
    const float* B0 = B + 2 * tig * kAfStride;
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      const float f0 = B0[k], f1 = B0[kAfStride + k];
      d[0] += a[0][k] * f0;
      d[1] += a[0][k] * f1;
      d[2] += a[1][k] * f0;
      d[3] += a[1][k] * f1;
    }
  }
};

// kStages chunks are in shared memory, kStages - 1 of them in flight.
// kPasses: more than kPassNt n-tiles (p >= 4); the one-pass instance
// leaves the pass bookkeeping out.
template <typename T, int kStages, bool kPasses>
__global__ void __launch_bounds__(kThreads, 1)
structured_apply_core(const Params<T> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* tab = reinterpret_cast<int*>(smem_raw);
  const int nt = P.nr / 8;
  for (int i = threadIdx.x; i < table_size(P); i += kThreads) {
    tab[i] = __ldg(P.tables + i);
  }
  const int* src = tab;
  const int* rowmap = src + P.nd;
  const int* ntgroup = rowmap + P.nr;
  const int* goff = ntgroup + nt;
  const int* gwin = goff + P.ng;
  const int* gshift = gwin + P.ng;
  const int* woff = gshift + P.ng;
  const int* wspan = woff + P.nw;
  const int* chanrows = wspan + P.nw;
  T* msk = reinterpret_cast<T*>(smem_raw + table_bytes(P));  // [ng][kTile]
  T* stage = msk + P.ng * kTile;
  const size_t stage_n = stage_elems(P.nr, P.nw);

  const int m0 = blockIdx.x * kTile;
  const int b = blockIdx.y;
  const T* ub = P.u + static_cast<size_t>(b) * P.C * P.Lu;
  __syncthreads();

  // The groups that reach this tile: some q = m0 - goff[g] + t in [0, Lp).
  unsigned gact = 0, wact = 0;
  for (int g = 0; g < P.ng; ++g) {
    const int q0 = m0 - goff[g];
    if (q0 < P.Lp && q0 + kTile > 0) {
      gact |= 1u << g;
      wact |= 1u << gwin[g];
    }
  }
  if (gact == 0) {  // every output of the tile is 0: nothing to stage
    T* yb = P.y + static_cast<size_t>(b) * P.C * P.Lu + m0;
    for (int i = threadIdx.x; i < P.C * kTile; i += kThreads) {
      yb[static_cast<size_t>(i / kTile) * P.Lu + i % kTile] = T(0);
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ct = warp & 3;         // column tile: t in [16 ct, 16 ct + 16)
  const int part = warp >> 2;      // n-tiles [j0, j0 + cnt) of the pass
  const int npass = kPasses ? (nt + kPassNt - 1) / kPassNt : 1;
  const int nchunks = (P.nd + kChunk - 1) / kChunk;

  // Pass `pass` owns the n-tiles [n0, n1): padded rows [r0, r1).
  for (int pass = 0; pass < npass; ++pass) {
    const int n0 = pass * nt / npass, n1 = (pass + 1) * nt / npass;
    const int r0 = 8 * n0, r1 = 8 * n1;

    // Stage k-chunk c of the pass's Af rows (two elements a copy: nd is
    // even) and of the active windows (one window row per warp at a time).
    auto stage_chunk = [&](int c) {
      T* As = stage + (c % kStages) * stage_n;
      T* Ws = As + static_cast<size_t>(r1 - r0) * kAfStride;
      const int k0 = c * kChunk;
      for (int i = threadIdx.x; i < (r1 - r0) * (kChunk / 2);
           i += kThreads) {
        const int r = i / (kChunk / 2), k = 2 * (i % (kChunk / 2));
        const int a = rowmap[r0 + r];
        const bool ok = a >= 0 && k0 + k < P.nd;
        copy_or_zero<2>(
            As + r * kAfStride + k,
            P.Af + (ok ? static_cast<size_t>(a) * P.nd + k0 + k : 0), ok);
      }
      for (int row = warp; row < P.nw * kChunk; row += kWarps) {
        const int w = row / kChunk, k = row % kChunk;
        if (!((wact >> w) & 1u)) continue;
        const int qw = m0 - woff[w];
        const bool krow = k0 + k < P.nd;
        const int base = krow ? src[k0 + k] + qw : 0;
        T* dst = Ws + (w * kChunk + k) * kWinStride;
        const int ncol = kTile + wspan[w];
        if (krow && qw >= 0 && qw + ncol <= P.Lp && (base & 1) == 0) {
          // All inside [0, Lp) and 16-byte aligned: two elements a copy.
          for (int j = 2 * lane; j < ncol; j += 64) {
            copy_or_zero<2>(dst + j, ub + base + j, true);
          }
        } else {
          for (int j = lane; j < ncol; j += 32) {
            const bool ok = krow && qw + j >= 0 && qw + j < P.Lp;
            copy_or_zero<1>(dst + j, ub + (ok ? base + j : 0), ok);
          }
        }
      }
    };

    const int j0 = n0 + part * (n1 - n0) / kParts;
    const int cnt = n0 + (part + 1) * (n1 - n0) / kParts - j0;
    int grp[kMaxNt];  // group of each of this warp's n-tiles; -1: none
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j) {
      const int g = j < cnt ? ntgroup[j0 + j] : -1;
      grp[j] = (g >= 0 && ((gact >> g) & 1u)) ? g : -1;
    }
    T acc[kMaxNt][4];
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = T(0);
    }

    // The mask of each group's columns q = m0 - goff[g] + t (0 outside
    // [0, Lp)) arrives with the first pass's chunk 0.
    for (int i = threadIdx.x; pass == 0 && i < P.ng * kTile; i += kThreads) {
      const int q = m0 - goff[i / kTile] + i % kTile;
      const bool ok = q >= 0 && q < P.Lp;
      copy_or_zero<1>(msk + i, P.mask + (ok ? q : 0), ok);
    }
    // k loop: chunk c + kStages - 1 is copied while chunk c is multiplied;
    // one barrier a chunk (it also frees chunk c - 1's stage for it).
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < nchunks) stage_chunk(c);
      copy_commit();
    }
    for (int c = 0; c < nchunks; ++c) {
      copy_wait<kStages - 2>();
      __syncthreads();
      const T* As = stage + (c % kStages) * stage_n;
      const T* Ws = As + static_cast<size_t>(r1 - r0) * kAfStride;
#pragma unroll
      for (int ks = 0; ks < kChunk; ks += kStep) {
        Frag<T> f;
        int cur = -1;
#pragma unroll
        for (int j = 0; j < kMaxNt; ++j) {
          if (grp[j] < 0) continue;
          if (grp[j] != cur) {
            cur = grp[j];
            f.load(Ws + (gwin[cur] * kChunk + ks) * kWinStride + 16 * ct +
                       gshift[cur],
                   gid, tig);
          }
          f.mma(acc[j], As + (8 * (j0 - n0 + j)) * kAfStride + ks, gid,
                tig);
        }
      }
      if (c + kStages - 1 < nchunks) stage_chunk(c + kStages - 1);
      copy_commit();
    }

    // The pass's products D (aliasing the stages, all copies done), then
    // each output y[b, ch, m0 + t] summed by one thread over its channel's
    // rows in [r0, r1) of active groups, masked, in group order: the first
    // pass writes every output, a later one adds to the outputs it reaches.
    __syncthreads();
    T* Ds = stage;  // [r1 - r0][kDStride]
    const int t0 = 16 * ct + gid;
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j) {
      if (grp[j] < 0) continue;
      T* d = Ds + (8 * (j0 - n0 + j) + 2 * tig) * kDStride + t0;
      d[0] = acc[j][0];
      d[kDStride] = acc[j][1];
      d[8] = acc[j][2];
      d[kDStride + 8] = acc[j][3];
    }
    __syncthreads();
    T* yb = P.y + static_cast<size_t>(b) * P.C * P.Lu + m0;
    for (int i = threadIdx.x; i < P.C * kTile; i += kThreads) {
      const int ch = i / kTile, t = i % kTile;
      T* yo = yb + static_cast<size_t>(ch) * P.Lu + t;
      T v = T(0);
      bool hit = !kPasses || pass == 0;
#pragma unroll
      for (int a = 0; a < kMaxA; ++a) {
        const int r = chanrows[ch * kMaxA + a];
        if (r < 0 || (kPasses && r >= r1)) break;
        const int g = ntgroup[r / 8];
        if ((kPasses && r < r0) || !((gact >> g) & 1u)) continue;
        if (!hit) {
          v = *yo;  // the earlier passes' sum
          hit = true;
        }
        v += msk[g * kTile + t] * Ds[(r - r0) * kDStride + t];
      }
      if (hit) *yo = v;
    }
    if (kPasses) __syncthreads();  // the next pass stages over D
  }
}

template <typename T, int kStages, bool kPasses>
int launch_instance(const Params<T>& P, int B, void* stream) {
  static size_t smem_allowed = 48 * 1024;  // raised once per size
  const size_t smem = smem_bytes(P, kStages);
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        structured_apply_core<T, kStages, kPasses>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  structured_apply_core<T, kStages, kPasses>
      <<<dim3(P.Lu / kTile, B), kThreads, smem,
          static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kStages>
int launch_stages(const Params<T>& P, int B, void* stream) {
  return P.nr / 8 > kPassNt ? launch_instance<T, kStages, true>(P, B, stream)
                            : launch_instance<T, kStages, false>(P, B, stream);
}

// Launch on `stream`; returns the first CUDA error (0 on success).  The
// caller guarantees Lu % kTile == 0.  Four stages where they fit in the
// card's shared memory (two windows, nz <= 30, at p = 3 in float64), else
// three, else two.
template <typename T>
int launch(const void* Af, const void* u, const void* mask, void* y,
           const void* tables, int B, int C, int nd, int Lp, int Lu, int nr,
           int ng, int nw, void* stream) {
  static int smem_limit = 0;
  if (smem_limit == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Params<T> P{static_cast<const T*>(Af),   static_cast<const T*>(u),
                    static_cast<const T*>(mask), static_cast<T*>(y),
                    static_cast<const int*>(tables), C, nd, Lp, Lu, nr, ng,
                    nw};
  const size_t limit = static_cast<size_t>(smem_limit);
  if (smem_bytes(P, 4) <= limit) return launch_stages<T, 4>(P, B, stream);
  if (smem_bytes(P, 3) <= limit) return launch_stages<T, 3>(P, B, stream);
  return launch_stages<T, 2>(P, B, stream);
}

}  // namespace
}  // namespace palace_core
