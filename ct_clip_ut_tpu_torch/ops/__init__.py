"""Primitives, attention, the transformer stack, VQ, and the wrappers of
the four CUDA kernels (attn_block, attn_packed, geglu_ff, vq_nearest)."""
