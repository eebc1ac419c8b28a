"""Classifier wrapper: softmax cross-entropy + accuracy.

Counterpart of ``StatefulClassifier`` in
``chainermn_tpu/models/classifier.py``.  The JAX version threads the
BatchNorm state through a functional ``loss``; here the model's buffers
carry it, and a train-mode forward updates them in place.
"""

import torch
import torch.nn.functional as F


class StatefulClassifier:
    """``loss(x, y) -> (loss, {'accuracy': ...})`` in train mode and
    per-example ``eval_metrics(x, y)`` with running statistics.  (The
    JAX version's auxiliary-head weighting comes with the first ported
    model that has auxiliary heads.)"""

    def __init__(self, model):
        self.model = model

    @staticmethod
    def _ce(logits, y, reduction='mean'):
        # optax.softmax_cross_entropy_with_integer_labels on f32 logits
        return F.cross_entropy(logits.float(), y.long(), reduction=reduction)

    def loss(self, x, y):
        self.model.train()
        logits = self.model(x)
        loss = self._ce(logits, y)
        acc = (logits.detach().argmax(-1) == y).float().mean()
        return loss, {'accuracy': acc}

    @torch.no_grad()
    def eval_metrics(self, x, y):
        """Per-example ``{'loss', 'accuracy'}`` with running statistics
        (the model is put back in its previous mode afterwards)."""
        was_training = self.model.training
        self.model.eval()
        try:
            logits = self.model(x)
        finally:
            self.model.train(was_training)
        return {'loss': self._ce(logits, y, reduction='none'),
                'accuracy': (logits.argmax(-1) == y).float()}
