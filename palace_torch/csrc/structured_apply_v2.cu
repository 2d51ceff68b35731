// Entry points of Pallas kernel #2's counterpart: the uniform box-hex
// Nedelec (ND) operator apply on the flattened padded lattice with channels
// in carry-class order, written by hand for Hopper (sm_90a).
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
// The work is done by the shared output-stationary core
// (structured_apply_core.cuh: design, bound and determinism are described
// there).  Its tables (ops/structured_kernel.py, `core_tables(p, shape,
// "class")`) list each E-vector row of the class slices with its channel
// and offset; consecutive rows of a slice read consecutive rows of u.

#include "structured_apply_core.cuh"

// Plain C interface (bound with ctypes).  Pointers are device pointers;
// `tables` is the int32 table block of the core; `stream` is the caller's
// cudaStream_t.  Returns the CUDA error of the launch (0 on success).
extern "C" int palace_structured_apply_v2_f64(
    const void* Af, const void* u, const void* mask, void* y,
    const void* tables, int B, int C, int nd, int Lp, int Lu, int nr, int ng,
    int nw, void* stream) {
  return palace_core::launch<double>(Af, u, mask, y, tables, B, C, nd, Lp,
                                     Lu, nr, ng, nw, stream);
}

extern "C" int palace_structured_apply_v2_f32(
    const void* Af, const void* u, const void* mask, void* y,
    const void* tables, int B, int C, int nd, int Lp, int Lu, int nr, int ng,
    int nw, void* stream) {
  return palace_core::launch<float>(Af, u, mask, y, tables, B, C, nd, Lp, Lu,
                                    nr, ng, nw, stream);
}
