"""The attribution suite's forward methods: raw attention maps, attention
rollout and occlusion sensitivity (counterpart of
ct_clip_ut_tpu/attribution/; the gradient methods, the suite runner and
embedding arithmetic are ROADMAP Queue 1 item 9 (c) and (d))."""

from . import capture, occlusion, raw_attention, rollout  # noqa: F401
