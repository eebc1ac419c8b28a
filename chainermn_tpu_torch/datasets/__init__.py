from chainermn_tpu_torch.datasets import imagenet  # noqa: F401
from chainermn_tpu_torch.datasets.empty_dataset import (  # noqa: F401
    create_empty_dataset)
