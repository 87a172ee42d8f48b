"""The benchmark of viabel_tpu_torch on one NVIDIA H100 (README.md)."""
