from chainermn_tpu_torch.utils.failure import (  # noqa: F401
    CommFailure, OverloadError)
