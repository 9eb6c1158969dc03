"""Data pipeline: NIfTI reading, the preprocessing chain, datasets and the
threaded loader (counterpart of ct_clip_ut_tpu/data/, copied, not imported)."""
