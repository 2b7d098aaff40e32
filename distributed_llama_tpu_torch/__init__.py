"""distributed_llama_tpu_torch — the PyTorch/CUDA port of distributed_llama_tpu.

The same inference system on an NVIDIA Hopper GPU: plain tensor code is PyTorch, and the
Pallas kernels of the JAX package are CUDA kernels written by hand (ops/*.py beside
csrc/*.cu). The package imports torch and numpy, never jax and never the JAX package.
"""

__version__ = "0.1.0"
