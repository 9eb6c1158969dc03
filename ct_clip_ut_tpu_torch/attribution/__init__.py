"""The attribution suite (counterpart of ct_clip_ut_tpu/attribution/): the
forward methods, raw attention maps, attention rollout and occlusion
sensitivity, and the gradient methods, Grad-CAM and integrated gradients,
all in fp32 over `capture`'s scored forward; `suite`, the runner that takes
them over a dataset and writes their artifacts; `embedding_arithmetic`, the
pathology diff embeddings occlusion's text-embeds mode reads."""

from . import (capture, embedding_arithmetic, grad_cam,  # noqa: F401
               integrated_gradients, occlusion, raw_attention, rollout, suite)
