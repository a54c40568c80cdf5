"""The benchmark of lumixengine_tpu_torch on one NVIDIA H100: see README.md."""
