"""repro_torch — the PyTorch + CUDA port of "Runtime Support for
Performance Portability on Heterogeneous Distributed Platforms".

Laid out module for module like the JAX package ``repro``: each module here
has its reference at the same relative path there. Entry points run on CUDA
unless the caller asks for the CPU (``RuntimeConfig(device="cpu")``).
"""
