"""Serving: autoregressive generation with continuous batching over a
slot or a paged KV cache, with prefix sharing, chunked prefill and
speculative decoding (counterpart of the ``GenerationEngine`` of
``chainermn_tpu.serving``; ROADMAP.md A8 lists what is not ported)."""

from chainermn_tpu_torch.serving.batcher import (  # noqa: F401
    bucket_edges, bucket_of, next_request_id)
from chainermn_tpu_torch.serving.generate import (  # noqa: F401
    GenerationEngine, GenerationQueue, GenRequest)
from chainermn_tpu_torch.serving.paged import (  # noqa: F401
    PagePool, RadixPrefixIndex, prefix_key)
