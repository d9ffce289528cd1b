"""The benchmark of the PyTorch / CUDA port (``sentinel_tpu_torch``); see
README.md beside this file."""
