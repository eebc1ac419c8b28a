"""Parallelism beyond data parallelism.

Counterpart of ``chainermn_tpu/parallel/``: each process drives one
device, so every mesh axis of the JAX package is a set of
``torch.distributed`` sub-groups over the processes, and an axis name
resolves to this process's group through the mesh that is bound
(:mod:`meshplan`).

- :mod:`meshplan` -- :class:`MeshPlan` (data x model) over a
  :class:`ProcessMesh`, and :class:`MeshPlanCommunicator`
- :mod:`tensor` -- Megatron tensor parallelism: column / row-sharded
  matmuls and the conjugate ``tp_copy`` / ``tp_reduce`` pair
- :mod:`sequence` -- ring and Ulysses attention, the mapped global loss
- :mod:`zero` -- ZeRO-1 optimizer-state sharding behind
  ``StandardUpdater(zero=True)``
- :mod:`pipeline` -- the GPipe and 1F1B schedules over a line of
  processes (one stage each), the bubble arithmetic and the 1F1B
  collective guard; trained through ``training.PipelineUpdater`` /
  ``MeshPipelineUpdater``

Not ported yet: ``moe`` (ROADMAP.md item 8).

Gradients: every process runs its own backward, so the JAX package's
"differentiate outside ``shard_map``" becomes a convention on what each
process seeds: a mapped global loss seeds each process's share and the
replicated gradients are summed afterwards (``sequence.sum_grads``); a
model that is tensor-parallel only seeds 1 everywhere and needs the
conjugate pair (see :mod:`tensor`).
"""

from chainermn_tpu_torch.parallel.meshplan import (  # noqa: F401
    Axis, MeshPlan, MeshPlanCommunicator, ProcessMesh, resolve_axis)
from chainermn_tpu_torch.parallel.tensor import (  # noqa: F401
    column_parallel_dense, psum, qkv_attention, row_parallel_dense,
    tp_attention, tp_copy, tp_mlp, tp_reduce, tp_transformer_block)
from chainermn_tpu_torch.parallel.sequence import (  # noqa: F401
    mapped_global_loss, ring_attention, sum_grads, ulysses_attention)
from chainermn_tpu_torch.parallel import pipeline, zero  # noqa: F401
from chainermn_tpu_torch.parallel.pipeline import (  # noqa: F401
    Pipeline, bubble_fraction, bubble_fractions_per_stage, microbatch,
    pipeline_1f1b_grads, schedule_ticks, stack_stage_params)
