from chainermn_tpu_torch.utils.failure import (  # noqa: F401
    Backoff, ChannelTimeout, CheckpointCorruptError, CommFailure,
    DataCorruptError, Deadline, DivergenceError, NanGuard, OverloadError,
    WeightSwapError, check_finite)
from chainermn_tpu_torch.utils.schedules import (  # noqa: F401
    distributed_sgd_schedule, gradual_warmup, linear_scaled_lr)
