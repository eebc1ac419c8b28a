"""Model zoo.

Counterpart of ``chainermn_tpu/models/__init__.py``: the port's
``nn.Module``s keep the JAX package's names, and :func:`get_arch` its
ImageNet registry.
"""

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


_NOT_PORTED = {
    'resnet50_s2d': 'the space_to_depth stem is not ported yet '
                    '(ROADMAP.md A3)',
    'alex': 'Alex is not ported yet (ROADMAP.md A6)',
    'googlenet': 'GoogLeNet is not ported yet (ROADMAP.md A6)',
    'googlenetbn': 'GoogLeNetBN is not ported yet (ROADMAP.md A6)',
    'nin': 'NIN is not ported yet (ROADMAP.md A6)',
    'vgg16': 'VGG16 is not ported yet (ROADMAP.md A6)',
}
_ARCHS = {'resnet50': ResNet50, 'resnet101': ResNet101,
          'resnet152': ResNet152}


def get_arch(name, **kwargs):
    """Architecture registry, with the JAX package's names (the
    reference's arch table, ``train_imagenet.py:103-109``); keyword
    arguments go to the model (``dtype``, ``device``, ...)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[name])
    if name not in _ARCHS:
        raise ValueError('unknown architecture %r (choose from %s)'
                         % (name, ', '.join(sorted(set(_ARCHS)
                                                   | set(_NOT_PORTED)))))
    return _ARCHS[name](**kwargs)
