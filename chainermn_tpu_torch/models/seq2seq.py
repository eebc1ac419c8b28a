"""LSTM encoder-decoder for NMT (``BASELINE.json`` config 4: "seq2seq /
NMT, dynamic define-by-run graph, variable-shape allreduce").

Counterpart of ``chainermn_tpu/models/seq2seq.py``: token embeddings,
``n_layers`` LSTM layers of flax's ``OptimizedLSTMCell`` over the source,
as many over the target with each decoder layer starting from its
encoder layer's final carry ``(c, h)``, and an f32 Dense to the target
vocabulary.  Sequences come in static-width buckets
(:func:`bucket_batches`), padded with 0 and with no sequence lengths:
the encoder runs over the pads, as the JAX model does, so
``pack_padded_sequence`` would compute something else.

The cell, as flax computes it under ``dtype``: the input kernels
``ii/if/ig/io`` (no bias) and the recurrent kernels ``hi/hf/hg/ho``
(with bias) are concatenated in ``i, f, g, o`` order; both products run
in ``dtype`` and round to it, as do their sum and the gates
(``sigmoid`` for i, f, o; ``tanh`` for g); the carry stays f32 (``c' =
f * c + i * g``, ``h' = o * tanh(c')``), so each layer's outputs are f32
and the next layer's product casts them to ``dtype``.  The parameters
keep flax's names and layouts (``encoder_<l>/cell/<gate>/kernel`` as
``(in, out)``), so ``flax_weights`` maps the trees.  The JAX package
computes all of this with jnp and optax, outside any Pallas kernel: no
kernel of the port lies on this model.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch.models._layers import Dense, _lecun_normal_
from chainermn_tpu_torch.ops._common import resolve_device

_GATES = ('i', 'f', 'g', 'o')


class _Kernel(nn.Module):
    """A flax ``DenseParams``: ``kernel`` ``(in, out)`` and an optional
    ``bias``, f32."""

    def __init__(self, kernel, bias):
        super().__init__()
        self.kernel = nn.Parameter(kernel)
        self.bias = None if bias is None else nn.Parameter(bias)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell(features)``: input kernels lecun-normal,
    recurrent kernels orthogonal, recurrent biases zero."""

    def __init__(self, in_features, features, generator):
        super().__init__()
        self.features = features
        for gate in _GATES:
            w = _lecun_normal_(torch.empty(in_features, features),
                               in_features, generator)
            setattr(self, 'i' + gate, _Kernel(w, None))
            u = nn.init.orthogonal_(torch.empty(features, features),
                                    generator=generator)
            setattr(self, 'h' + gate, _Kernel(u, torch.zeros(features)))

    def weights(self, dtype):
        """The concatenated ``(in, 4H)`` input kernel and ``(H, 4H)``
        recurrent kernel and ``(4H,)`` bias, in ``dtype``."""
        wi = torch.cat([getattr(self, 'i' + g).kernel for g in _GATES], 1)
        wh = torch.cat([getattr(self, 'h' + g).kernel for g in _GATES], 1)
        bh = torch.cat([getattr(self, 'h' + g).bias for g in _GATES])
        return wi.to(dtype), wh.to(dtype), bh.to(dtype)


def lstm_layer(cell, xs, carry, dtype):
    """Run ``cell`` over ``xs`` ``(B, T, in)`` from ``carry`` ``(c, h)``
    (f32); returns the final carry and the f32 outputs ``(B, T, H)``."""
    wi, wh, bh = cell.weights(dtype)
    # the input products of every step at once: each element is the
    # same dot product as flax's per-step one
    xw = torch.matmul(xs.to(dtype), wi)
    c, h = carry
    n = cell.features
    outs = []
    for t in range(xs.shape[1]):
        z = torch.matmul(h.to(dtype), wh).add_(bh).add_(xw[:, t])
        i = torch.sigmoid(z[:, :n])
        f = torch.sigmoid(z[:, n:2 * n])
        g = torch.tanh(z[:, 2 * n:3 * n])
        o = torch.sigmoid(z[:, 3 * n:])
        c = f.float() * c + (i * g).float()
        h = o.float() * torch.tanh(c)
        outs.append(h)
    return (c, h), torch.stack(outs, 1)


class Seq2seq(nn.Module):
    """The encoder-decoder; ``forward(xs, ys_in)`` takes ``(B, Ts)`` and
    ``(B, Tt)`` int token ids and returns f32 logits ``(B, Tt,
    n_target_vocab)``.  Parameters are made on the CPU from
    ``generator`` (default: seed 0) and moved to ``device`` (default: the
    current CUDA device; raises when there is none)."""

    def __init__(self, n_layers=2, n_source_vocab=8000, n_target_vocab=8000,
                 n_units=512, dtype=torch.bfloat16, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.n_layers = n_layers
        self.n_units = n_units
        self.dtype = dtype
        for name, vocab in (('embed_x', n_source_vocab),
                            ('embed_y', n_target_vocab)):
            emb = nn.Module()
            # flax Embed: variance 1 / features, truncated at 2 std
            emb.embedding = nn.Parameter(_lecun_normal_(
                torch.empty(vocab, n_units), n_units, generator))
            setattr(self, name, emb)
        for side in ('encoder', 'decoder'):
            for layer in range(n_layers):
                rnn = nn.Module()
                rnn.cell = LSTMCell(n_units, n_units, generator)
                setattr(self, '%s_%d' % (side, layer), rnn)
        self.out = Dense(n_units, n_target_vocab, dtype=torch.float32,
                         generator=generator)
        self.to(device)

    def _embed(self, emb, ids):
        return F.embedding(ids.long(), emb.embedding.to(self.dtype))

    def forward(self, xs, ys_in):
        h = self._embed(self.embed_x, xs)
        zeros = torch.zeros((xs.shape[0], self.n_units),
                            dtype=torch.float32, device=xs.device)
        carries = []
        for layer in range(self.n_layers):
            carry, h = lstm_layer(getattr(self, 'encoder_%d' % layer).cell,
                                  h, (zeros, zeros), self.dtype)
            carries.append(carry)
        h = self._embed(self.embed_y, ys_in)
        for layer, carry in enumerate(carries):
            _, h = lstm_layer(getattr(self, 'decoder_%d' % layer).cell, h,
                              carry, self.dtype)
        return self.out(h).float()


def seq2seq_loss(model, pad_id=0):
    """``loss_fn(xs, ys_in, ys_out) -> (loss, {'perp': exp(loss)})``:
    the token cross-entropy (optax's
    ``softmax_cross_entropy_with_integer_labels``) averaged over the
    positions where ``ys_out != pad_id``."""

    def loss_fn(xs, ys_in, ys_out):
        logits = model(xs, ys_in)
        mask = (ys_out != pad_id).float()
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             ys_out.reshape(-1).long(), reduction='none')
        total = (ce * mask.reshape(-1)).sum()
        loss = total / torch.clamp_min(mask.sum(), 1.0)
        return loss, {'perp': torch.exp(loss.detach())}

    return loss_fn


def bucket_batches(pairs, bucket_widths=(8, 16, 32, 64), pad_id=0):
    """Group ``(src, tgt)`` token-id sequences into static-width buckets:
    ``{width: (xs, ys_in, ys_out)}`` int32 arrays, each sequence in the
    narrowest bucket that holds it (longer ones truncated to the widest),
    ``ys_in`` starting with BOS (1) and ``ys_out`` ending with EOS (2),
    padded with ``pad_id``."""
    buckets = {}
    widest = max(bucket_widths)
    for src, tgt in pairs:
        src, tgt = list(src)[:widest], list(tgt)[:widest - 1]
        width = next(w for w in sorted(bucket_widths)
                     if w >= max(len(src), len(tgt) + 1))
        buckets.setdefault(width, []).append((src, tgt))
    out = {}
    for width, items in buckets.items():
        xs = np.full((len(items), width), pad_id, np.int32)
        yin = np.full((len(items), width), pad_id, np.int32)
        yout = np.full((len(items), width), pad_id, np.int32)
        for i, (src, tgt) in enumerate(items):
            xs[i, :len(src)] = src
            yin[i, 0] = 1  # BOS
            yin[i, 1:len(tgt) + 1] = tgt
            yout[i, :len(tgt)] = tgt
            yout[i, len(tgt)] = 2  # EOS
        out[width] = (xs, yin, yout)
    return out
