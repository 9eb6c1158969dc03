"""Data parallelism over torch.distributed (ct_clip_ut_tpu/parallel's data axis)."""
