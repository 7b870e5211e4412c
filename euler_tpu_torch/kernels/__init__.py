"""Build/load machinery for the CUDA sources under euler_tpu_torch/csrc."""
