"""PyTorch/CUDA port of simplerecon_tpu's hero-model inference.

The JAX package `simplerecon_tpu` is the reference; each module here has
the same name as its counterpart there. Plain tensor code is PyTorch in
NCHW; the fused plane sweep is a hand-written CUDA kernel
(`csrc/fused_sweep.cu`, bound in `ops/cuda_cv.py`). Nothing in this
package imports jax, flax, yaml or PIL.
"""
