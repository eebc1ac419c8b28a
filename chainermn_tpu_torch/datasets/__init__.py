from chainermn_tpu_torch.datasets import imagenet, mnist  # noqa: F401
from chainermn_tpu_torch.datasets.empty_dataset import (  # noqa: F401
    create_empty_dataset)
from chainermn_tpu_torch.datasets.mnist import (  # noqa: F401
    TupleDataset, get_mnist)
