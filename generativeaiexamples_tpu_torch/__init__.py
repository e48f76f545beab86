"""PyTorch/CUDA port of the generative-AI example stack.

The JAX package ``generativeaiexamples_tpu`` stays the reference; this
package runs the same serving path on an NVIDIA GPU with hand-written
Hopper kernels under ``csrc/``. It imports ``torch`` and never ``jax``.
"""
