"""din_tpu_torch: PyTorch/CUDA port of din_tpu for one NVIDIA H100 (serving slice)."""
