"""Hand-written Hopper kernels of the port, one module per Pallas file of the JAX
package, each kernel with its plain PyTorch version beside it. CUDA sources live in `embodied_clip_tpu_torch/csrc/`
and are compiled on first use (`_build.py`), never at import."""
