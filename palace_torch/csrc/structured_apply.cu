// Entry points of Pallas kernel #1's counterpart: the uniform box-hex
// Nedelec (ND) operator apply on the flattened padded lattice, channels in
// natural order, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel palace_tpu/ops/pallas_structured.py:241
// structured_apply_flat (pallas_call at :263, body `_kernel` at :222).  Per
// batch column b the TPU kernel gathers the E-vector
//     ul[a, :] = u[b, chan[a], off[a] : off[a] + Lp]
// into VMEM, runs one (nd x nd) MXU matmul v = Af ul, masks the pad-plane
// columns and slice-adds v[a, :] back into y[b, chan[a], off[a] : ...].
//
// The work is done by the shared output-stationary core
// (structured_apply_core.cuh: design, bound and determinism are described
// there).  In the natural layout each local dof's E-vector row is its own
// one-row gather piece: the core's tables (ops/structured_kernel.py,
// `core_tables(p, shape, "natural")`) list its channel and offset.

#include "structured_apply_core.cuh"

// Plain C interface (bound with ctypes).  Pointers are device pointers;
// `tables` is the int32 table block of the core; `stream` is the caller's
// cudaStream_t.  Returns the CUDA error of the launch (0 on success).
extern "C" int palace_structured_apply_f64(
    const void* Af, const void* u, const void* mask, void* y,
    const void* tables, int B, int C, int nd, int Lp, int Lu, int nr, int ng,
    int nw, void* stream) {
  return palace_core::launch<double>(Af, u, mask, y, tables, B, C, nd, Lp,
                                     Lu, nr, ng, nw, stream);
}

extern "C" int palace_structured_apply_f32(
    const void* Af, const void* u, const void* mask, void* y,
    const void* tables, int B, int C, int nd, int Lp, int Lu, int nr, int ng,
    int nw, void* stream) {
  return palace_core::launch<float>(Af, u, mask, y, tables, B, C, nd, Lp, Lu,
                                    nr, ng, nw, stream);
}
