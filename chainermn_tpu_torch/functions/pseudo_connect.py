"""Graph-splicing identity.

Counterpart of ``chainermn_tpu/functions/pseudo_connect.py``.  In the
JAX package every dependency is explicit and the function is a
zero-weighted add; in the port, as in the reference ChainerMN, autograd
only visits what the loss reaches, so the function does real work: a
rank whose loss does not depend on its own ``send`` calls would never
run their backward (the ``recv`` of the gradient that the peer's
backward is sending), and the two ranks would wait on each other.
Tying the sends in as the delegate of what the rank returns makes
``loss.backward()`` visit them, with a zero gradient.
"""

import torch


def _tensors(tree):
    """The tensors of a tensor, or of a nested list / tuple / dict."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for leaf in tree for t in _tensors(leaf)]
    return []


class _PseudoConnect(torch.autograd.Function):
    """Forward: the actuals, unchanged.  Backward: the actuals'
    gradients pass through; every delegate gets zeros."""

    @staticmethod
    def forward(ctx, n_delegates, *tensors):
        ctx.delegates = [(t.shape, t.dtype, t.device)
                         for t in tensors[:n_delegates]]
        return tuple(a.view_as(a) for a in tensors[n_delegates:])

    @staticmethod
    def backward(ctx, *grads):
        zeros = tuple(
            torch.zeros(shape, dtype=dtype, device=device)
            if ctx.needs_input_grad[1 + i] else None
            for i, (shape, dtype, device) in enumerate(ctx.delegates))
        return (None,) + zeros + grads


def pseudo_connect(delegate_variable, *actual_variables):
    """The ``actual_variables``, made to depend on
    ``delegate_variable`` (a tensor or a nested list / tuple / dict of
    them) without changing their values: the actuals' gradients pass
    through and the delegate gets a zero gradient, so that a backward
    from the result also runs the delegate's backward.  A ``None``
    delegate returns the actual itself (a tuple for several)."""
    if delegate_variable is None:
        return (actual_variables[0] if len(actual_variables) == 1
                else actual_variables)
    delegates = _tensors(delegate_variable)
    out = _PseudoConnect.apply(len(delegates), *delegates,
                               *actual_variables)
    return out[0] if len(out) == 1 else out
