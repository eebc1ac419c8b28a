"""Utilities: the failure taxonomy and liveness (``failure``), the
append-only ledgers (``ledger``), seeded fault injection (``chaos``),
profiling (``profiling``: traces, the step timer, the op benchmark) and
the learning-rate schedules (``schedules``).

Two modules of the JAX package's ``utils`` have no counterpart here, on
purpose: ``utils/platform.py`` picks and configures the JAX backend
(TPU, its CPU fallback, XLA flags), which PyTorch does per tensor
(``ops._common.resolve_device``); ``utils/jax_compat.py`` bridges JAX
API versions.  Neither has a torch meaning.
"""

from chainermn_tpu_torch.utils import chaos  # noqa: F401
from chainermn_tpu_torch.utils.chaos import FaultInjector  # noqa: F401
from chainermn_tpu_torch.utils.failure import (  # noqa: F401
    Backoff, ChannelTimeout, CheckpointCorruptError,
    CheckpointSkippedWarning, CommFailure, DataCorruptError, Deadline,
    DivergenceError, Heartbeat, NanGuard, OverloadError, PeerDeadError,
    ReplicaDeadError, WeightSwapError, check_finite, classify_exit,
    detect_stall, exit_code_for, heartbeat_extension, read_heartbeat)
from chainermn_tpu_torch.utils.ledger import Ledger  # noqa: F401
from chainermn_tpu_torch.utils import profiling  # noqa: F401
from chainermn_tpu_torch.utils.schedules import (  # noqa: F401
    distributed_sgd_schedule, gradual_warmup, linear_scaled_lr)
