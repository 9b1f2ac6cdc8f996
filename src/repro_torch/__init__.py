"""repro_torch: the PyTorch/CUDA port of ``repro`` (Chiron — hierarchical
autoscaling for LLM serving) for one NVIDIA H100.

Same sub-package and module names as ``repro`` so every counterpart is
easy to find. The package imports ``torch`` and ``numpy`` only: never
``jax`` and nothing of ``repro``. The kernels that ``repro.kernels``
writes in Pallas are hand-written CUDA C++ here (``kernels/csrc``).
"""

__version__ = "0.1.0"
