"""The benchmark harness of palace_torch on one NVIDIA H100."""
