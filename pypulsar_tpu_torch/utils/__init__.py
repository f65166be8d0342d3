"""utils layer of the PyTorch/CUDA port (mirrors pypulsar_tpu/utils)."""
