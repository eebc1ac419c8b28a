"""Serving: dynamic request batching over one CUDA graph per bucket, and
autoregressive generation with continuous batching.

Counterpart of ``chainermn_tpu.serving``:

- :mod:`~chainermn_tpu_torch.serving.batcher` -- the bounded
  :class:`RequestQueue` that coalesces variable-size requests into padded,
  power-of-two-bucketed batches with deterministic packing, deadlines and
  the typed :class:`OverloadError` shed;
- :mod:`~chainermn_tpu_torch.serving.engine` -- the
  :class:`InferenceEngine`, one CUDA graph per bucket, the no-recompile
  guard, int8 weights (:class:`~chainermn_tpu_torch.precision.
  Int8Policy`), hot swaps and checkpoint loading (:func:`load_params`);
- :mod:`~chainermn_tpu_torch.serving.loadgen` -- the open-loop load
  generators :func:`open_loop` and :func:`open_loop_generate`;
- :mod:`~chainermn_tpu_torch.serving.generate` -- the
  :class:`GenerationEngine` over a slot or a paged KV cache, with prefix
  sharing, chunked prefill and speculative decoding;
- :mod:`~chainermn_tpu_torch.serving.paged` -- the page accounting.

Not ported yet (ROADMAP.md A8): ``serving/fleet.py`` (the replica fleet),
tensor-parallel serving, and the generation engine's per-bucket graphs.
"""

from chainermn_tpu_torch.serving.batcher import (  # noqa: F401
    PackedBatch, Request, RequestQueue, admission_order, bucket_edges,
    bucket_of, next_request_id, pack_sizes, record_shed)
from chainermn_tpu_torch.serving.engine import (  # noqa: F401
    InferenceEngine, load_params)
from chainermn_tpu_torch.serving.generate import (  # noqa: F401
    GenerationEngine, GenerationQueue, GenRequest)
from chainermn_tpu_torch.serving.loadgen import (  # noqa: F401
    open_loop, open_loop_generate)
from chainermn_tpu_torch.serving.paged import (  # noqa: F401
    PagePool, RadixPrefixIndex, prefix_key)
from chainermn_tpu_torch.utils.failure import OverloadError  # noqa: F401
