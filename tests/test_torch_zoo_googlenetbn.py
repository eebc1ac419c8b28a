"""The port's GoogLeNet-BN against the JAX package's model, from the
same flax weights (``tests/zoo_parity.py`` holds the set-up): the
eval-mode logits (f32, rtol 1e-5 of the largest logit), every gradient
(rtol 1e-4, both models in float64) and the exact flax round trip; in
train mode, under ``fused_norm`` False and True (on the CPU both run the
plain versions: this holds the model's wiring of the BN op), its
logits, the running averages it leaves (batch statistics at momentum
0.9, flax's biased variance) and its gradients in float64 against the
JAX model, and the f32 fused model against the f32 unfused one; the 68
BN interludes of a forward.
"""

import jax
import numpy as np
import pytest
import torch

import zoo_parity
from chainermn_tpu_torch import models
from chainermn_tpu_torch.models import googlenetbn

torch.set_num_threads(2)


def test_eval_logits_and_gradients_match_jax():
    zoo_parity.check_eval('googlenetbn', 64, 4)


def _stats(model):
    return dict(jax.tree_util.tree_leaves_with_path(
        models.to_flax_variables(model)['batch_stats']))


@pytest.mark.parametrize('fused', [False, True])
def test_googlenetbn_train_mode_matches_jax(fused):
    """Logits, running averages and gradients in float64 (the fused
    path's plain versions compute in the input's type) against the JAX
    model's unfused path, which shares its variable tree."""
    _, v, x, y, _ = zoo_parity.setup('googlenetbn', 64, 4)
    logits64, state, jgrads = zoo_parity.jax64('googlenetbn', 64, 4, True)
    port = zoo_parity.port64('googlenetbn', 64, v, fused_norm=fused)
    port.train()
    got = zoo_parity.backward64(port, x, y)
    np.testing.assert_allclose(got, logits64,
                               **zoo_parity.tol(logits64, 1e-5))
    got_stats = _stats(port)
    want = dict(jax.tree_util.tree_leaves_with_path(state['batch_stats']))
    assert set(got_stats) == set(want)
    for path, leaf in want.items():
        np.testing.assert_allclose(got_stats[path], leaf, rtol=1e-5,
                                   atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    zoo_parity.check_grads(port, jgrads)


def test_googlenetbn_fused_matches_unfused_in_f32():
    """The fused model (the kernels' plain versions here) against the
    unfused one, both f32, from the same weights and batch: logits at
    rtol 1e-5, running averages at 1e-5, gradients at 1e-4."""
    _, v, x, y, unfused = zoo_parity.setup('googlenetbn', 64, 4)
    fused = models.GoogLeNetBN(num_classes=10, insize=64, fused_norm=True,
                               dtype=torch.float32, device='cpu')
    models.load_flax_variables(fused, v)
    outs = []
    for model in (unfused, fused):
        model.train()
        logits = model(torch.from_numpy(x))
        torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(y).long()).backward()
        outs.append(logits.detach().numpy())
    np.testing.assert_allclose(outs[1], outs[0],
                               **zoo_parity.tol(outs[0], 1e-5))
    a, b = _stats(unfused), _stats(fused)
    for path in a:
        np.testing.assert_allclose(b[path], a[path], rtol=1e-5, atol=1e-6)
    for (name, p), q in zip(unfused.named_parameters(), fused.parameters()):
        np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(),
                                   **zoo_parity.tol(p.grad.numpy(), 1e-4),
                                   err_msg=name)


def test_googlenetbn_has_68_interludes():
    """Counted from the structure: 2 in the stem, 7 in each module with
    a 1x1 branch and a projection, 5 in the two stride-2 ones."""
    with torch.device('meta'):
        model = models.GoogLeNetBN(device='meta')
    per_module = [7 if n1 else 5 for n1, *_ in googlenetbn._MODULES]
    assert model.n_norms == 2 + sum(per_module) == 68
