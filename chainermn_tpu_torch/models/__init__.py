from chainermn_tpu_torch.models._norm import NormAct, norm_act  # noqa: F401
from chainermn_tpu_torch.models.classifier import (  # noqa: F401
    StatefulClassifier)
from chainermn_tpu_torch.models.flax_weights import (  # noqa: F401
    load_flax_variables, to_flax_variables)
from chainermn_tpu_torch.models.resnet50 import (  # noqa: F401
    Bottleneck, ResNet, ResNet50, ResNet101, ResNet152)
