"""Meshes: loading, generation, refinement and cracking (host numpy; the
modules are copies of palace_tpu/mesh/*, imports pointed at palace_torch)."""
