"""The attribution suite (counterpart of ct_clip_ut_tpu/attribution/): the
forward methods, raw attention maps, attention rollout and occlusion
sensitivity, and the gradient methods, Grad-CAM and integrated gradients,
all in fp32 over `capture`'s scored forward (the suite runner and
embedding arithmetic are ROADMAP Queue 1 item 9 (d))."""

from . import (capture, grad_cam, integrated_gradients, occlusion,  # noqa: F401
               raw_attention, rollout)
