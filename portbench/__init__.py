"""The benchmark of the PyTorch/CUDA port (jabd_tpu_torch) on one H100:
harness, traffic, configurations, reference and readers. It measures the
port only and loads neither JAX nor the JAX package."""
