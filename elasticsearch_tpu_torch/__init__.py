"""elasticsearch_tpu_torch — the PyTorch + CUDA port of elasticsearch_tpu.

A package of its own beside the JAX reference: it imports torch and never
jax, and nothing of ``elasticsearch_tpu``. The hand-written Hopper kernels
live in ``csrc/`` and build with nvcc at first use (``ops/_build.py``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
