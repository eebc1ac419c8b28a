"""Model zoo.

Counterpart of ``chainermn_tpu/models/__init__.py``: the port's
``nn.Module``s keep the JAX package's names, and :func:`get_arch` its
ImageNet registry.
"""

from chainermn_tpu_torch.models._norm import NormAct, norm_act  # noqa: F401
from chainermn_tpu_torch.models.classifier import (  # noqa: F401
    Classifier, StatefulClassifier, classifier_loss)
from chainermn_tpu_torch.models.flax_weights import (  # noqa: F401
    gather_variables, load_flax_variables, param_tree, shard_variables,
    to_flax_variables)
from chainermn_tpu_torch.models.mlp import MLP  # noqa: F401
from chainermn_tpu_torch.models._layers import (  # noqa: F401
    Dropout, set_dropout_generator)
from chainermn_tpu_torch.models.alex import Alex  # noqa: F401
from chainermn_tpu_torch.models.googlenet import GoogLeNet  # noqa: F401
from chainermn_tpu_torch.models.googlenetbn import (  # noqa: F401
    GoogLeNetBN, InceptionBN)
from chainermn_tpu_torch.models.nin import NIN  # noqa: F401
from chainermn_tpu_torch.models.resnet50 import (  # noqa: F401
    Bottleneck, ResNet, ResNet50, ResNet101, ResNet152,
    convert_stem_variables, s2d_stem_kernel)
from chainermn_tpu_torch.models.seq2seq import (  # noqa: F401
    Seq2seq, bucket_batches, seq2seq_loss)
from chainermn_tpu_torch.models.transformer import (  # noqa: F401
    TransformerBlock, TransformerLM, decode_step, decode_step_paged,
    init_kv_cache, init_paged_kv_cache, lm_loss, lm_loss_sum,
    pipeline_parts, pipeline_stage_specs, prefill, prefill_paged,
    spec_verify, spec_verify_paged, tp_oracle, tp_param_specs)
from chainermn_tpu_torch.models.vgg import VGG, VGG16  # noqa: F401


def _resnet50_s2d(**kwargs):
    """ResNet-50 on the space-to-depth stem: the weight-mapped
    equivalent of ``resnet50`` (``models.convert_stem_variables``)."""
    return ResNet50(stem='space_to_depth', **kwargs)


_ARCHS = {'alex': Alex, 'googlenet': GoogLeNet, 'googlenetbn': GoogLeNetBN,
          'nin': NIN, 'resnet50': ResNet50, 'resnet50_s2d': _resnet50_s2d,
          'resnet101': ResNet101, 'resnet152': ResNet152, 'vgg16': VGG16}


def get_arch(name, **kwargs):
    """Architecture registry, with the JAX package's names (the
    reference's arch table, ``train_imagenet.py:103-109``); keyword
    arguments go to the model (``dtype``, ``device``, ``insize``, ...).
    Every model takes ``insize`` and keeps it as an attribute; VGG's,
    Alex's and GoogLeNet's widths follow it (a Dense after a flatten)."""
    if name not in _ARCHS:
        raise ValueError('unknown architecture %r (choose from %s)'
                         % (name, ', '.join(sorted(_ARCHS))))
    return _ARCHS[name](**kwargs)
