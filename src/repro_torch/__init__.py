"""PyTorch + CUDA port of the two-phase MPC federated-learning system.

Mirrors the JAX package ``repro`` (``core/``, ``fl/``,
``kernels/<family>/{kernel,ref,ops}.py``, ``models/``, ``data/``), which
stays the reference the port is held against.  The port imports neither
JAX nor ``repro``.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; a kernel's wrapper runs the CUDA kernel
for a CUDA tensor and its plain PyTorch version for a CPU tensor.
"""
