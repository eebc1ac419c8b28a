from chainermn_tpu_torch.utils.failure import (  # noqa: F401
    CheckpointCorruptError, CommFailure, DivergenceError, NanGuard,
    OverloadError, check_finite)
