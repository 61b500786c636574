"""fantoch_tpu_torch: the PyTorch/CUDA port of fantoch_tpu for NVIDIA Hopper.

The JAX package ``fantoch_tpu`` is the reference; this package re-builds it
slice by slice with the same module names.  Plain tensor code is PyTorch;
every Pallas kernel of the reference becomes a hand-written CUDA C++ kernel
for ``sm_90a`` under ``csrc/``, built on first use (``ops/_build.py``).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without CUDA and without an explicit device they raise.
Nothing here imports ``jax`` or ``fantoch_tpu``.
"""

__version__ = "0.1.0"
