"""The benchmark of kmerset_tpu_torch on one NVIDIA H100 (see harness)."""
