"""repro_torch — the PyTorch + CUDA port of the SSV serving path.

The JAX package ``repro`` stays the reference; this package mirrors its
module names (``config``, ``configs``, ``models``, ``core``, ``kernels``,
``data``, ``launch``) and imports nothing of it. Plain tensor code is
PyTorch; the fused NSA-verify and routing kernels are CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use and loaded with ``ctypes``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
