"""ct_clip_ut_tpu_torch — the PyTorch + CUDA port of ct_clip_ut_tpu.

The JAX package beside it is the reference; this package imports `torch`
and never `jax`. It ports the CT-CLIP zero-shot scoring path (prompt
latents once per checkpoint, then CT-ViT -> VQ -> projection -> pairwise
softmax per batch of volumes) and the single-card train step with its
driver, with the module layout of the JAX package (config, ops/, models/,
infer/, train/), and replaces the TPU kernels on those paths with CUDA C++
kernels for the H100 (sm_90a) under `csrc/`, built at first use by
`_build.py`. Each kernel has a plain PyTorch version beside
its wrapper: CPU tensors take it, CUDA tensors launch the kernel.
"""

__version__ = "0.1.0"
