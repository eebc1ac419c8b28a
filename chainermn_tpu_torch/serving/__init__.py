"""Serving: slot-KV-cache autoregressive generation with continuous
batching (counterpart of ``chainermn_tpu.serving``, the slot mode of its
``GenerationEngine`` so far; ROADMAP.md A8 lists the rest)."""

from chainermn_tpu_torch.serving.batcher import (  # noqa: F401
    bucket_edges, bucket_of, next_request_id)
from chainermn_tpu_torch.serving.generate import (  # noqa: F401
    GenerationEngine, GenerationQueue, GenRequest)
