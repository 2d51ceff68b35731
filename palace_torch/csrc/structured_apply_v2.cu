// Uniform box-hex Nedelec (ND) operator apply on the flattened padded
// lattice with channels in carry-class order, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel palace_tpu/ops/pallas_structured.py:151
// structured_apply_flat_v2 (pallas_call at :179, body `_kernel_v2` at :132;
// tables `_class_tables` :67, `v2_tables` :198).  With the lattice channels
// permuted by perm_c and the element matrix by perm_l (Af_perm), every
// (delta group, channel class) of local dofs is a block of nr consecutive
// E-vector rows fed by nr consecutive channels at one flat offset:
//     ul[r0 + i, m] = u[b, c0 + i, off + m]      for each slice (r0, nr, c0, off)
// The TPU kernel gathers ul (nd, Lp) into VMEM with ~15 such block copies,
// multiplies v = Af_perm ul in row chunks, masks the pad-plane columns and
// slice-adds v back into y in grid order.
//
// On Hopper blocks run in parallel, in no order, so the scatter-add into one
// output block has no counterpart.  This version runs in two kernels:
//  (a) gather + product: one CTA per (b, tile of kTile lattice columns)
//      stages the E-vector tile ul[nd, kTile] in shared memory through the
//      class slices (each slice row is kTile consecutive elements of one
//      row of u: coalesced, and a box a later TMA version can copy whole),
//      then computes vl[b, r, m] = mask[m] * sum_k Af_perm[r, k] ul[k, m]
//      into a (B, nd, Lp) scratch tensor.  Each thread owns one column and
//      kRows rows per pass; Af_perm rows are warp-uniform broadcasts
//      (__ldg), ul reads are conflict-free rows of shared memory.
//  (b) scatter as a pull: one thread per output y[b, c, m] sums
//      vl[b, r, m - off] over the (at most four) (r, off) pairs of the
//      slices that land on channel c, in slice order.  Every output is
//      written once, with no atomics: results are deterministic, and
//      positions no slice covers stay 0 as in `_kernel_v2`.
//
// What bounds it on the card: the compulsory traffic is one read of u and
// one write of y (B*C*Lu elements each: 53 MB each way, about 106 MB, at the
// main-path shape B = 16, C = 81, Lu = 5120 of a 16^3 mesh in float64), and
// the useful work is 2 nd^2 per real cell and column (2.7 GFLOP in float64
// at that shape, nd = 144).  The scratch round trip adds 2 B*nd*Lp elements
// (85 MB each way at that shape).  Tensor cores (DMMA/wgmma) and TMA are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;         // lattice columns per CTA of kernel (a)
constexpr int kWarps = 8;         // warps per CTA of kernel (a)
constexpr int kRows = 6;          // E-vector rows per thread and pass
constexpr int kMaxA = 4;          // local dofs that map to one channel
constexpr int kPullThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
class_gather_product(const T* __restrict__ Af, const T* __restrict__ u,
                     const T* __restrict__ mask, T* __restrict__ vl,
                     const int* __restrict__ slices, int nslices, int C,
                     int nd, int Lp, int Lu) {
  extern __shared__ unsigned char smem_raw[];
  T* ul = reinterpret_cast<T*>(smem_raw);  // [nd][kTile]
  const int b = blockIdx.y;
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int m = blockIdx.x * kTile + t;  // < Lp: Lp is a multiple of kTile
  const T* ub = u + static_cast<size_t>(b) * C * Lu;
  for (int s = 0; s < nslices; ++s) {
    const int r0 = __ldg(slices + 4 * s);
    const int nr = __ldg(slices + 4 * s + 1);
    const int c0 = __ldg(slices + 4 * s + 2);
    const int off = __ldg(slices + 4 * s + 3);
    for (int i = w; i < nr; i += kWarps) {
      ul[(r0 + i) * kTile + t] =
          ub[static_cast<size_t>(c0 + i) * Lu + off + m];
    }
  }
  __syncthreads();
  const T wm = __ldg(mask + m);
  T* vb = vl + static_cast<size_t>(b) * nd * Lp;
  // Rows r = w + kWarps * (kRows * pass + j): every row once.
  for (int rb = w; rb < nd; rb += kWarps * kRows) {
    T acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = T(0);
    for (int k = 0; k < nd; ++k) {
      const T x = ul[k * kTile + t];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = rb + j * kWarps;
        if (r < nd) acc[j] += __ldg(Af + static_cast<size_t>(r) * nd + k) * x;
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = rb + j * kWarps;
      if (r < nd) vb[static_cast<size_t>(r) * Lp + m] = wm * acc[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kPullThreads)
class_scatter_pull(const T* __restrict__ vl, T* __restrict__ y,
                   const int* __restrict__ arow, const int* __restrict__ aoff,
                   int C, int nd, int Lp, int Lu) {
  const int m = blockIdx.x * kPullThreads + threadIdx.x;
  const int bc = blockIdx.y;  // b * C + c
  if (m >= Lu) return;
  const int c = bc % C;
  const T* vb = vl + static_cast<size_t>(bc / C) * nd * Lp;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < kMaxA; ++k) {
    const int r = __ldg(arow + c * kMaxA + k);
    if (r < 0) break;
    const int q = m - __ldg(aoff + c * kMaxA + k);
    if (q < 0 || q >= Lp) continue;
    acc += vb[static_cast<size_t>(r) * Lp + q];
  }
  y[static_cast<size_t>(bc) * Lu + m] = acc;
}

template <typename T>
int launch(const void* Af, const void* u, const void* mask, void* vl, void* y,
           const void* slices, const void* arow, const void* aoff,
           int nslices, int B, int C, int nd, int Lp, int Lu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(T) * static_cast<size_t>(nd) * kTile;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        class_gather_product<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  class_gather_product<T><<<dim3(Lp / kTile, B), kWarps * 32, smem, st>>>(
      static_cast<const T*>(Af), static_cast<const T*>(u),
      static_cast<const T*>(mask), static_cast<T*>(vl),
      static_cast<const int*>(slices), nslices, C, nd, Lp, Lu);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  class_scatter_pull<T><<<dim3((Lu + kPullThreads - 1) / kPullThreads, B * C),
                          kPullThreads, 0, st>>>(
      static_cast<const T*>(vl), static_cast<T*>(y),
      static_cast<const int*>(arow), static_cast<const int*>(aoff), C, nd, Lp,
      Lu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes).  Pointers are device pointers; vl
// is a (B, nd, Lp) scratch tensor the caller allocates; `stream` is the
// caller's cudaStream_t.  Returns the first CUDA error of the launches (0 on
// success).
extern "C" int palace_structured_apply_v2_f64(
    const void* Af, const void* u, const void* mask, void* vl, void* y,
    const void* slices, const void* arow, const void* aoff, int nslices,
    int B, int C, int nd, int Lp, int Lu, void* stream) {
  return launch<double>(Af, u, mask, vl, y, slices, arow, aoff, nslices, B, C,
                        nd, Lp, Lu, stream);
}

extern "C" int palace_structured_apply_v2_f32(
    const void* Af, const void* u, const void* mask, void* vl, void* y,
    const void* slices, const void* arow, const void* aoff, int nslices,
    int B, int C, int nd, int Lp, int Lu, void* stream) {
  return launch<float>(Af, u, mask, vl, y, slices, arow, aoff, nslices, B, C,
                       nd, Lp, Lu, stream);
}
