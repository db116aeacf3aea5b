"""PyTorch + CUDA port of the two-phase MPC federated-learning system.

Mirrors the JAX package ``repro`` (``core/``, ``fl/``,
``kernels/<family>/{kernel,ref,ops}.py``, ``models/``, ``data/``), which
stays the reference the port is held against.  The port imports neither
JAX nor ``repro``.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; a kernel's wrapper runs the CUDA kernel
for a CUDA tensor and its plain PyTorch version for a CPU tensor.
"""

__all__ = ["ExperimentSpec", "ReproDeprecationWarning"]


def __getattr__(name):
    # the typed experiment API, loaded on first use so that importing a
    # kernel module does not import the federated-learning loops
    if name == "ExperimentSpec":
        from .api import ExperimentSpec
        return ExperimentSpec
    if name == "ReproDeprecationWarning":
        from .deprecation import ReproDeprecationWarning
        return ReproDeprecationWarning
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
