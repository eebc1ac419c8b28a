"""Classifier wrappers: softmax cross-entropy + accuracy.

Counterpart of ``chainermn_tpu/models/classifier.py``.  The JAX versions
wrap an apply function and take the parameters as an argument; here
the module carries its weights, so ``loss(x, y)`` and
``eval_metrics(x, y)`` take the batch alone.  The JAX package computes
these losses with ``optax`` (not with its Pallas cross-entropy), so
the port uses ``F.cross_entropy`` on f32 logits.
"""

import torch
import torch.nn.functional as F


def _ce(logits, y, reduction='mean', label_smoothing=0.0):
    """optax's ``softmax_cross_entropy_with_integer_labels`` (or, with
    ``label_smoothing`` alpha, ``softmax_cross_entropy`` against
    ``smooth_labels``: ``(1 - alpha) * onehot + alpha / n``)."""
    return F.cross_entropy(logits.float(), y.long(), reduction=reduction,
                           label_smoothing=label_smoothing)


def _accuracy(logits, y):
    """Per-example hits, f32."""
    return (logits.detach().argmax(-1) == y).float()


def _logits(out):
    """The logits of a model that may return ``(logits, aux)``."""
    return out[0] if isinstance(out, tuple) else out


def classifier_loss(model, label_smoothing=0.0):
    """``loss_fn(x, y) -> (loss, {'accuracy': ...})``, the batch mean of
    each."""

    def loss_fn(x, y):
        logits = _logits(model(x))
        loss = _ce(logits, y, label_smoothing=label_smoothing)
        return loss, {'accuracy': _accuracy(logits, y).mean()}

    return loss_fn


class Classifier:
    """Object flavor for symmetry with ``L.Classifier``: callable as the
    updater's loss function, with per-example ``eval_metrics`` for the
    evaluator."""

    def __init__(self, model, label_smoothing=0.0):
        self.model = model
        self._loss = classifier_loss(model, label_smoothing)

    def __call__(self, x, y):
        return self._loss(x, y)

    loss = __call__

    @torch.no_grad()
    def eval_metrics(self, x, y):
        """Per-example ``{'loss', 'accuracy'}``, arrays of shape
        ``(batch,)`` (no label smoothing, as in the JAX package)."""
        logits = _logits(self.model(x))
        return {'loss': _ce(logits, y, reduction='none'),
                'accuracy': _accuracy(logits, y)}


class StatefulClassifier:
    """Classifier for models with state in their buffers (BatchNorm):
    ``loss(x, y) -> (loss, {'accuracy': ...})`` in train mode (a
    train-mode forward updates the running statistics in place; the
    JAX version threads that state through a functional ``loss``) and
    per-example ``eval_metrics(x, y)`` with running statistics.

    A model that returns ``(logits, auxes)`` in train mode (GoogLeNet's
    auxiliary heads) adds ``aux_weight * CE(aux)`` for each ``aux`` that
    is not ``None``, as the reference weights them."""

    def __init__(self, model, aux_weight=0.3):
        self.model = model
        self.aux_weight = aux_weight

    def loss(self, x, y):
        self.model.train()
        out = self.model(x)
        if isinstance(out, tuple):
            logits, auxes = out
            loss = _ce(logits, y)
            for aux in auxes:
                if aux is not None:
                    loss = loss + self.aux_weight * _ce(aux, y)
        else:
            logits = out
            loss = _ce(logits, y)
        return loss, {'accuracy': _accuracy(logits, y).mean()}

    @torch.no_grad()
    def eval_metrics(self, x, y):
        """Per-example ``{'loss', 'accuracy'}`` with running statistics
        (the model is put back in its previous mode afterwards)."""
        was_training = self.model.training
        self.model.eval()
        try:
            logits = _logits(self.model(x))
        finally:
            self.model.train(was_training)
        return {'loss': _ce(logits, y, reduction='none'),
                'accuracy': _accuracy(logits, y)}
