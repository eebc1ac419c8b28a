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
- :mod:`~chainermn_tpu_torch.serving.paged` -- the page accounting;
- :mod:`~chainermn_tpu_torch.serving.fleet` -- train-to-serve continuous
  deployment: a :class:`FleetController` rolling snapshots of the training
  checkpoint chain (:class:`CheckpointWatcher`) through N replicas behind a
  canary-routing :class:`FleetFront`, judged live by per-replica SLO
  monitors (:class:`CanaryJudge`), with rollback, the append-only
  ``fleet_ledger.jsonl``, the crash-safe :class:`RequestJournal` whose
  exact-replay continuations recover a dead replica's generations, and
  the :class:`ReplicaSupervisor` (respawn, :class:`DegradationPolicy`).
  CLI: ``python -m chainermn_tpu_torch.serving.fleet``.

Tensor-parallel serving is the engines' ``plan=`` / ``param_specs=``
(one process a device, SPMD); :func:`kv_cache_specs` (the models') says
how a cache shards its heads.
"""

from chainermn_tpu_torch.models.transformer import (  # noqa: F401
    kv_cache_specs)
from chainermn_tpu_torch.serving.batcher import (  # noqa: F401
    PackedBatch, Request, RequestQueue, admission_order, bucket_edges,
    bucket_of, next_request_id, pack_sizes, record_shed)
from chainermn_tpu_torch.serving.engine import (  # noqa: F401
    InferenceEngine, load_params)
from chainermn_tpu_torch.serving.fleet import (  # noqa: F401
    CanaryJudge, CheckpointWatcher, DegradationPolicy, FleetController,
    FleetFront, FrontHandle, LocalReplica, ReplicaSupervisor,
    RequestJournal, SubprocessReplica, apply_degradation_rung,
    build_local_fleet, canary_slice, local_respawn_fn,
    strip_oneshot_kills)
from chainermn_tpu_torch.serving.generate import (  # noqa: F401
    GenerationEngine, GenerationQueue, GenRequest)
from chainermn_tpu_torch.serving.loadgen import (  # noqa: F401
    open_loop, open_loop_generate)
from chainermn_tpu_torch.serving.paged import (  # noqa: F401
    PagePool, RadixPrefixIndex, prefix_key)
from chainermn_tpu_torch.utils.failure import OverloadError  # noqa: F401
