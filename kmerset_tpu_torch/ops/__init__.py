"""Device layer: the CUDA kernels' wrappers (pack, compact), the counting
pipeline built on them (count) and the host<->device staging (backend)."""
