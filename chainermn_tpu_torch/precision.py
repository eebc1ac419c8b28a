"""Mixed-precision policy.

Counterpart of ``chainermn_tpu/precision.py``: :func:`cast_floating`,
:class:`Policy` (four dtypes and an optional loss scale, with the
``f32()`` / ``bf16()`` / ``f16()`` registry and ``from_string``),
:func:`all_finite`, :func:`tree_select`, :class:`LossScaleState`,
:class:`StaticLossScale` and :class:`DynamicLossScale` (GradScaler-style:
a non-finite step backs the scale off and is skipped by the caller), and
the KV-cache quantization pair :func:`quantize_kv` /
:func:`dequantize_kv`, and the int8 weight policy: :class:`QuantizedLeaf`,
:data:`QUANT_MIN_ELEMS`, :func:`is_quantized`, :func:`quantize_int8`,
:func:`dequantize_int8`, :func:`quantization_error`,
:func:`dequantized_view` and :class:`Int8Policy`.  Dtypes are
``torch.dtype``s; a tree is a nested ``dict`` (the layout of a flax
tree), a list or a tuple of tensors.

The cast points live in the training stack, not the model:
``StandardUpdater(policy=)`` casts the f32 master parameters to the
compute dtype inside the differentiated region, so every gradient comes
back in f32 through the cast (see :mod:`chainermn_tpu_torch.training.updater`).
"""

import collections.abc
from typing import NamedTuple

import numpy as np
import torch


def cast_floating(tree, dtype):
    """Cast every floating-point tensor of a nested ``dict`` to ``dtype``
    (integer and bool tensors pass through; ``dtype=None`` is the
    identity).  A tensor already of ``dtype`` is returned as it is, not
    copied."""
    if dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point() \
            and tree.dtype != dtype:
        return tree.to(dtype)
    return tree


def _leaves(tree):
    """The tensors of a nested ``dict`` / list / tuple, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def _map(fn, tree, *rest):
    """``fn`` over the leaves of same-structure trees."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def all_finite(tree):
    """0-d bool tensor: every element of every floating leaf is finite
    (True for a tree without floating leaves).  One reduction a leaf,
    no host sync."""
    checks = [torch.isfinite(x).all() for x in _leaves(tree)
              if x.is_floating_point()]
    if not checks:
        return torch.tensor(True)
    if len(checks) == 1:
        return checks[0]
    return torch.stack(checks).all()


def tree_select(pred, on_true, on_false):
    """Leafwise ``where(pred, a, b)`` over two same-structure trees --
    the skip-on-nonfinite primitive."""
    return _map(lambda a, b: torch.where(pred, a, b), on_true, on_false)


class LossScaleState(NamedTuple):
    """Carried loss-scale state: ``scale`` (f32 0-d tensor) and
    ``growth_count`` (int32 0-d tensor, consecutive finite steps)."""
    scale: torch.Tensor
    growth_count: torch.Tensor


class StaticLossScale:
    """Fixed loss scale: ``adjust`` is the identity."""

    def __init__(self, scale):
        if scale <= 0:
            raise ValueError('loss scale must be positive')
        self.initial_scale = float(scale)

    def init(self, device=None):
        return LossScaleState(
            scale=torch.tensor(self.initial_scale, dtype=torch.float32,
                               device=device),
            growth_count=torch.zeros((), dtype=torch.int32, device=device))

    def scale(self, tree, state):
        return _map(lambda x: x * state.scale.to(x.dtype), tree)

    def unscale(self, tree, state):
        inv = 1.0 / state.scale
        return _map(lambda x: x * inv.to(x.dtype), tree)

    def adjust(self, state, grads_finite):
        del grads_finite
        return state


class DynamicLossScale(StaticLossScale):
    """GradScaler-style dynamic loss scaling.

    Every step with finite unscaled gradients increments a counter;
    after ``growth_interval`` consecutive finite steps the scale
    multiplies by ``growth_factor``.  A non-finite step multiplies the
    scale by ``backoff_factor`` (floored at ``min_scale``) and resets
    the counter -- the caller SKIPS that step's update
    (``StandardUpdater`` does).  Scales are powers of two by
    construction, so scaling and unscaling are exact in every binary
    float dtype.  ``adjust`` selects on the device (``torch.where``):
    it never reads the verdict on the host.
    """

    def __init__(self, initial_scale=2.0 ** 15, growth_interval=2000,
                 growth_factor=2.0, backoff_factor=0.5, min_scale=1.0):
        super().__init__(initial_scale)
        if growth_interval < 1:
            raise ValueError('growth_interval must be >= 1')
        if not 0.0 < backoff_factor < 1.0:
            raise ValueError('backoff_factor must be in (0, 1)')
        if growth_factor <= 1.0:
            raise ValueError('growth_factor must be > 1')
        self.growth_interval = int(growth_interval)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.min_scale = float(min_scale)

    def adjust(self, state, grads_finite):
        finite = torch.as_tensor(grads_finite, device=state.scale.device)
        grown = state.growth_count + 1
        should_grow = grown >= self.growth_interval
        fin_scale = torch.where(should_grow,
                                state.scale * self.growth_factor,
                                state.scale)
        fin_count = torch.where(should_grow, torch.zeros_like(grown), grown)
        new_scale = torch.where(
            finite, fin_scale,
            torch.clamp_min(state.scale * self.backoff_factor,
                            self.min_scale))
        new_count = torch.where(finite, fin_count, torch.zeros_like(grown))
        return LossScaleState(scale=new_scale.to(torch.float32),
                              growth_count=new_count.to(torch.int32))


def quantize_kv(x):
    """Per-vector symmetric int8 quantization over the LAST axis:
    ``scale = max|x| / 127`` per vector (1 for an all-zero vector),
    ``q = round(x / scale)`` clipped to +-127.  Returns ``(q int8 of
    x.shape, scale float32 of x.shape[:-1])``.

    ``torch.round`` rounds half to even, as ``jnp.round`` does, and the
    divisions are the same float32 operations, so the two packages
    quantize a cache to the same bits."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv` (up to rounding)."""
    return q.to(dtype) * scale[..., None].to(dtype)


class QuantizedLeaf(NamedTuple):
    """One int8-quantized weight: ``q`` (int8, the weight's shape),
    ``scale`` (float32, one per output channel) and ``axis``, the output
    channel's axis of ``q`` (-1 for a flax-layout kernel, 0 for a
    PyTorch module's ``weight``)."""
    q: torch.Tensor
    scale: torch.Tensor
    axis: int = -1


def is_quantized(x):
    return isinstance(x, QuantizedLeaf)


#: leaves smaller than this stay in float: biases and norm scales are a
#: rounding error of the weight bytes, and quantizing them costs accuracy
QUANT_MIN_ELEMS = 1024


def _channel_axis(name):
    """The output-channel axis of a leaf by its name, the layout rule of
    :mod:`~chainermn_tpu_torch.models.flax_weights`: a ``weight`` is a
    PyTorch kernel (OIHW, or ``(out, in)``), output channel first; every
    other leaf keeps flax's layout (HWIO, ``(in, out)``, the transformer's
    ``kernel``s and ``embedding``), output channel last."""
    return 0 if name == 'weight' else -1


def _quantize_leaf(w, axis):
    """Per-channel symmetric int8: ``scale = max|w| / 127`` over every
    axis but ``axis`` (1 for an all-zero channel), ``q = round(w /
    scale)`` clipped to +-127, in float32 as the JAX package computes it
    (``torch.round`` rounds half to even, as ``jnp.round`` does), so the
    two packages give the same ``q``."""
    wf = torch.as_tensor(w).float()
    axis = axis % wf.dim()
    others = tuple(d for d in range(wf.dim()) if d != axis)
    amax = wf.abs().amax(dim=others)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    shape = [1] * wf.dim()
    shape[axis] = -1
    q = torch.clamp(torch.round(wf / scale.reshape(shape)), -127, 127)
    return QuantizedLeaf(q=q.to(torch.int8), scale=scale,
                         axis=-1 if axis == wf.dim() - 1 else axis)


def _eligible(w, min_elems):
    t = torch.as_tensor(w) if isinstance(w, np.ndarray) else w
    return (torch.is_tensor(t) and t.is_floating_point() and t.dim() >= 2
            and t.numel() >= min_elems)


def quantize_int8(tree, min_elems=QUANT_MIN_ELEMS):
    """Per-channel symmetric int8 quantization of a weight tree (nested
    dicts of tensors or numpy arrays).

    Floating leaves with ``ndim >= 2`` and at least ``min_elems``
    elements become :class:`QuantizedLeaf` s, scaled per output channel
    (:func:`_channel_axis`: the last axis of a flax-layout leaf, as in the
    JAX package; axis 0 of a PyTorch ``weight``).  Everything else
    (biases, norms, small leaves, integer leaves) passes through."""
    def one(name, w):
        if isinstance(w, dict):
            return {k: one(k, v) for k, v in w.items()}
        if not _eligible(w, min_elems):
            return w
        return _quantize_leaf(w, _channel_axis(name))

    return {k: one(k, v) for k, v in tree.items()}


def _dequant(leaf, dtype):
    from chainermn_tpu_torch.ops.int8_matmul import dequant
    return dequant(leaf.q, leaf.scale, dtype, axis=leaf.axis)


def dequantize_int8(tree, dtype=torch.float32):
    """Inverse of :func:`quantize_int8` (up to rounding): every
    :class:`QuantizedLeaf` becomes a ``dtype`` tensor, every other
    floating leaf is cast to ``dtype``."""
    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if is_quantized(x):
            return _dequant(x, dtype)
        if isinstance(x, np.ndarray) and np.issubdtype(x.dtype,
                                                       np.floating):
            x = torch.as_tensor(x)
        if torch.is_tensor(x) and x.is_floating_point():
            return x.to(dtype)
        return x

    return one(tree)


def quantization_error(tree, qtree):
    """The worst relative Frobenius error over the quantized leaves of
    ``qtree`` (:func:`quantize_int8` of ``tree``): ``||w - deq(q)|| /
    max(||w||, 1e-12)`` in float32, the load-time sanity number
    (per-channel symmetric int8 lands around 1e-2 for well-scaled
    weights); 0.0 when nothing is quantized."""
    errs = []

    def walk(w, qw):
        if isinstance(qw, dict):
            for k in qw:
                walk(w[k], qw[k])
        elif is_quantized(qw):
            wf = torch.as_tensor(np.asarray(w) if isinstance(w, np.ndarray)
                                 else w).to(torch.float32)
            deq = _dequant(qw, torch.float32).to(wf.device)
            num = torch.linalg.norm(wf - deq)
            den = torch.clamp(torch.linalg.norm(wf), min=1e-12)
            errs.append(float(num / den))

    walk(tree, qtree)
    return max(errs) if errs else 0.0


class _DequantizedView(collections.abc.Mapping):
    """A read-only view of a quantized tree whose :class:`QuantizedLeaf` s
    are dequantized when they are read (see :func:`dequantized_view`)."""

    __slots__ = ('_tree', '_dtype')

    def __init__(self, tree, dtype):
        self._tree = tree
        self._dtype = dtype

    def __getitem__(self, key):
        value = self._tree[key]
        if isinstance(value, dict):
            return _DequantizedView(value, self._dtype)
        if is_quantized(value):
            return _dequant(value, self._dtype)
        return value

    def __iter__(self):
        return iter(self._tree)

    def __len__(self):
        return len(self._tree)


def dequantized_view(tree, dtype):
    """``tree`` with each :class:`QuantizedLeaf` dequantized to ``dtype``
    when a forward reads it, just before the layer that uses it runs: the
    whole tree is never dequantized at once, so a forward holds the int8
    weights and one layer's dequantized weight, not a second copy of the
    model.  Other leaves are returned as they are."""
    return _DequantizedView(tree, dtype)


def _name(dtype):
    """A dtype's name as the JAX package prints it (``'bfloat16'``)."""
    return str(dtype).replace('torch.', '')


class Policy:
    """Dtype policy for one training run: the master dtype of the
    parameters, the dtype the model computes in, the dtype gradients
    are reduced in (``None``: their own), the dtype of the outputs
    (``None``: the compute dtype), and an optional loss scale
    (:class:`StaticLossScale` / :class:`DynamicLossScale`)."""

    def __init__(self, param_dtype=torch.float32,
                 compute_dtype=torch.float32, reduce_dtype=None,
                 output_dtype=None, loss_scale=None):
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype
        self.reduce_dtype = reduce_dtype
        self.output_dtype = output_dtype
        self.loss_scale = loss_scale

    # -- casts ----------------------------------------------------------
    def cast_to_compute(self, tree):
        return cast_floating(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return cast_floating(tree, self.param_dtype)

    def cast_to_output(self, tree):
        return cast_floating(tree, self.output_dtype or self.compute_dtype)

    def cast_to_reduce(self, tree):
        return cast_floating(tree, self.reduce_dtype)

    def upcast_from_reduce(self, tree, like):
        """Restore each reduced leaf to its pre-reduction dtype."""
        if self.reduce_dtype is None:
            return tree
        return _map(lambda r, g: r.to(g.dtype), tree, like)

    # -- introspection --------------------------------------------------
    def declared_dtypes(self):
        """The names of the dtypes this policy declares reductions and
        compute may narrow to."""
        out = {_name(self.compute_dtype)}
        if self.reduce_dtype is not None:
            out.add(_name(self.reduce_dtype))
        return out

    # -- registry -------------------------------------------------------
    @classmethod
    def f32(cls):
        """Full precision (the identity policy)."""
        return cls()

    @classmethod
    def bf16(cls):
        """bf16 compute and reduce, f32 master weights, f32 outputs.
        bf16 keeps f32's exponent, so no loss scaling is needed."""
        return cls(param_dtype=torch.float32,
                   compute_dtype=torch.bfloat16,
                   reduce_dtype=torch.bfloat16,
                   output_dtype=torch.float32)

    @classmethod
    def f16(cls, loss_scale=None):
        """float16 compute and reduce with f32 masters and dynamic loss
        scaling (f16's 5-bit exponent underflows gradients without
        it)."""
        return cls(param_dtype=torch.float32,
                   compute_dtype=torch.float16,
                   reduce_dtype=torch.float16,
                   output_dtype=torch.float32,
                   loss_scale=(loss_scale if loss_scale is not None
                               else DynamicLossScale()))

    @classmethod
    def from_string(cls, name):
        """``'f32'|'float32'``, ``'bf16'|'bfloat16'``,
        ``'f16'|'float16'`` -> the matching policy."""
        table = {'f32': cls.f32, 'float32': cls.f32,
                 'bf16': cls.bf16, 'bfloat16': cls.bf16,
                 'f16': cls.f16, 'float16': cls.f16}
        try:
            return table[name.lower()]()
        except KeyError:
            raise ValueError(
                'unknown precision policy %r (choose from %s)'
                % (name, ', '.join(sorted(table)))) from None

    def __repr__(self):
        names = [None if d is None else _name(d) for d in (
            self.param_dtype, self.compute_dtype, self.reduce_dtype,
            self.output_dtype)]
        scale = (type(self.loss_scale).__name__
                 if self.loss_scale is not None else None)
        return ('Policy(param=%s, compute=%s, reduce=%s, output=%s, '
                'loss_scale=%s)' % (*names, scale))

    def __eq__(self, other):
        return (isinstance(other, Policy)
                and self.param_dtype == other.param_dtype
                and self.compute_dtype == other.compute_dtype
                and self.reduce_dtype == other.reduce_dtype
                and self.output_dtype == other.output_dtype
                and self.loss_scale is other.loss_scale)

    def __hash__(self):
        return hash((self.param_dtype, self.compute_dtype,
                     self.reduce_dtype, self.output_dtype,
                     id(self.loss_scale)))


class Int8Policy(Policy):
    """Int8-weight inference policy (forward-only).

    Weights are stored int8 with per-channel symmetric float32 scales
    (:func:`quantize_int8`, computed once at load), activations run in
    ``compute_dtype`` (float32 by default, bf16 from :meth:`bf16`), and
    each weight is dequantized just before the layer that reads it
    (:func:`dequantized_view`; the serving engines).  ``min_elems`` is
    the size floor of a quantized leaf (:data:`QUANT_MIN_ELEMS`)."""

    #: the serving engines key their quantized path on this flag
    is_inference_only = True

    def __init__(self, compute_dtype=torch.float32, output_dtype=None,
                 min_elems=QUANT_MIN_ELEMS):
        super().__init__(param_dtype=torch.int8,
                         compute_dtype=compute_dtype,
                         output_dtype=output_dtype)
        self.min_elems = int(min_elems)

    def quantize(self, params):
        """The load-time transform: float weight tree -> mixed tree of
        :class:`QuantizedLeaf` s and passthrough leaves."""
        return quantize_int8(params, min_elems=self.min_elems)

    def dequantize(self, qparams):
        """The inverse at this policy's compute dtype, whole tree at once
        (the engines use :func:`dequantized_view` instead)."""
        return dequantize_int8(qparams, self.compute_dtype)

    @classmethod
    def bf16(cls):
        """bf16 activations over int8 weights, f32 outputs."""
        return cls(compute_dtype=torch.bfloat16,
                   output_dtype=torch.float32)

    @classmethod
    def from_string(cls, name):
        """``'int8'`` (f32 activations) or ``'int8_bf16'``."""
        table = {'int8': cls, 'int8_f32': cls, 'int8_bf16': cls.bf16}
        try:
            return table[name.lower()]()
        except KeyError:
            raise ValueError(
                'unknown int8 policy %r (choose from %s)'
                % (name, ', '.join(sorted(table)))) from None
