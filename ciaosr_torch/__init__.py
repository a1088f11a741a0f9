"""PyTorch/CUDA port of ciaosr_tpu for NVIDIA Hopper (H100).

Mirrors ciaosr_tpu's layout (core/, ops/, models/, convert/). Plain tensor
work is PyTorch; every Pallas kernel of the ported slice is a CUDA C++
kernel under csrc/, built by nvcc at first use (ops/kernels/_build.py).
Nothing here imports JAX.
"""
