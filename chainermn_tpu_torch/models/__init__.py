from chainermn_tpu_torch.models._norm import NormAct, norm_act  # noqa: F401
from chainermn_tpu_torch.models.classifier import (  # noqa: F401
    Classifier, StatefulClassifier, classifier_loss)
from chainermn_tpu_torch.models.flax_weights import (  # noqa: F401
    load_flax_variables, param_tree, to_flax_variables)
from chainermn_tpu_torch.models.mlp import MLP  # noqa: F401
from chainermn_tpu_torch.models.resnet50 import (  # noqa: F401
    Bottleneck, ResNet, ResNet50, ResNet101, ResNet152)
from chainermn_tpu_torch.models.transformer import (  # noqa: F401
    TransformerBlock, TransformerLM, decode_step, decode_step_paged,
    init_kv_cache, init_paged_kv_cache, lm_loss, lm_loss_sum, prefill,
    prefill_paged, spec_verify, spec_verify_paged)
