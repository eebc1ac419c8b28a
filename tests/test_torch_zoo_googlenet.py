"""The port's GoogLeNet against the JAX package's model, from the same
flax weights (``tests/zoo_parity.py`` holds the set-up): the eval-mode
logits (f32, rtol 1e-5 of the largest logit), every gradient (rtol
1e-4, both models in float64) and the exact flax round trip; the
auxiliary heads in train mode, at a size where their pools find an
empty map as flax's do.
"""

import torch

import zoo_parity
from chainermn_tpu_torch import models

torch.set_num_threads(2)


def test_eval_logits_and_gradients_match_jax():
    zoo_parity.check_eval('googlenet', 96, 2)


def test_googlenet_train_mode_returns_aux_heads():
    model = models.GoogLeNet(num_classes=10, insize=64, device='cpu')
    out = model(torch.zeros(2, 64, 64, 3))
    assert isinstance(out, tuple) and len(out[1]) == 2
    # at 64 px the auxiliary pools find a 4 x 4 map under a 5 x 5
    # window: the heads' logits are their biases, as in flax
    assert model._AuxHead_0.Dense_0.weight.shape == (1024, 0)
    for aux in out[1]:
        assert aux.shape == (2, 10)
    loss, _ = models.StatefulClassifier(model).loss(
        torch.zeros(2, 64, 64, 3), torch.zeros(2, dtype=torch.long))
    loss.backward()
    model.eval()
    assert model(torch.zeros(2, 64, 64, 3)).shape == (2, 10)


def test_imagenet_twin_trains_googlenet_quick(tmp_path):
    """The ImageNet twin with ``--arch googlenet --quick``: the JAX
    script's smoke size (64 px), the auxiliary heads in the loss, dropout
    from the updater's generator, one epoch in a world of one."""
    from chainermn_tpu_torch.examples.imagenet import train_imagenet
    trainer = train_imagenet.main([
        '--cpu', '--quick', '--dtype', 'float32', '--arch', 'googlenet',
        '--batchsize', '32', '--val_batchsize', '32', '--out',
        str(tmp_path / 'result')])
    try:
        model = trainer.updater.model
        assert model.insize == 64
        assert trainer.updater.dropout_generator is model.dropout.generator
        obs = trainer.observation
        assert trainer.updater.iteration == 16
        # CE of the logits + 0.3 x two auxiliary CEs, about 1.6 x ln 1000
        assert 10.0 < obs['loss'] < 12.0
        assert 0.0 <= obs['validation/main/accuracy'] <= 1.0
    finally:
        train_imagenet.close(trainer)
