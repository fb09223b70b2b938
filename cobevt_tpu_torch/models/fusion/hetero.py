"""Heterogeneous / temporal agent attention (V2X-ViT carry-overs).

Counterpart of ``cobevt_tpu/models/fusion/hetero.py`` (reference
``opv2v/opencood/models/base_transformer.py``):

  * :func:`sinusoid_table` and :func:`cav_positional_encoding`, the
    per-agent-slot sinusoid (reference :61);
  * :class:`RTE`, the sinusoid of each agent's delay through a linear layer
    (reference :14 / :40);
  * :class:`HGTCavAttention`, heterogeneous-graph attention across the agents
    of each BEV pixel: each agent type has its own q/k/v/out projections and
    each (type_i, type_j) relation its own attention and message transforms
    (reference :175).

Every type's projection is computed and the agent's own is selected by a
one-hot, as in the JAX package (the reference loops over batch x agent x
agent).  The score products, the mask and the softmax run in f32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cobevt_tpu_torch.nn.layers import dropout

NEG_INF = -1e9


@functools.lru_cache(maxsize=None)
def sinusoid_table(max_len: int, dim: int, scaled: bool = False):
    """(max_len, dim) f32 sin/cos table; ``scaled`` divides by sqrt(dim)
    (the RTE variant)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) *
                 -(math.log(10000.0) / dim))
    tab = np.zeros((max_len, dim))
    tab[:, 0::2] = np.sin(pos * div)
    tab[:, 1::2] = np.cos(pos * div)
    if scaled:
        tab /= math.sqrt(dim)
    return tab.astype(np.float32)


def _table(max_len, dim, like, scaled=False):
    return torch.tensor(sinusoid_table(max_len, dim, scaled),
                        device=like.device, dtype=like.dtype)


def cav_positional_encoding(x):
    """Add the per-agent-slot sinusoid to x (B, L, H, W, C)."""
    L, C = x.shape[1], x.shape[-1]
    return x + _table(L, C, x)[None, :, None, None, :]


class RTE(nn.Module):
    """x + Linear(sinusoid(delay * ratio)) per agent."""

    def __init__(self, dim: int, rte_ratio: int = 2, max_len: int = 100):
        super().__init__()
        self.dim = dim
        self.rte_ratio = rte_ratio
        self.max_len = max_len
        self.emb_lin = nn.Linear(dim, dim)

    def forward(self, x, dts):
        """x: (B, L, H, W, C); dts: (B, L) integer delays."""
        table = _table(self.max_len, self.dim, self.emb_lin.weight,
                       scaled=True)
        idx = (dts.long() * self.rte_ratio).clamp(0, self.max_len - 1)
        emb = self.emb_lin(table[idx])
        return x + emb[:, :, None, None, :]


class HGTCavAttention(nn.Module):
    """Typed multi-head attention across the agents of each BEV pixel."""

    def __init__(self, dim: int, heads: int, num_types: int = 2,
                 num_relations: int = 4, dim_head: int = 64,
                 dropout: float = 0.1):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.num_types = num_types
        self.num_relations = num_relations
        self.dropout = dropout
        inner = heads * dim_head
        for name, (c_in, c_out) in (("q_linears", (dim, inner)),
                                    ("k_linears", (dim, inner)),
                                    ("v_linears", (dim, inner)),
                                    ("a_linears", (inner, dim))):
            self.add_module(name, nn.ModuleList(
                [nn.Linear(c_in, c_out) for _ in range(num_types)]))
        shape = (num_relations, heads, dim_head, dim_head)
        self.relation_att = nn.Parameter(torch.empty(shape))
        self.relation_msg = nn.Parameter(torch.empty(shape))
        self.reset_relations()

    @torch.no_grad()
    def reset_relations(self, generator=None):
        """Draw ``relation_att`` and ``relation_msg`` as flax's
        ``xavier_uniform`` does: the leading axes are the receptive field,
        so fan_in = fan_out = dh x heads x R."""
        bound = math.sqrt(3.0 / self.relation_att[0].numel())
        for p in (self.relation_att, self.relation_msg):
            u = torch.rand(p.shape, generator=generator)
            p.copy_((2.0 * u - 1.0) * bound)

    @staticmethod
    def _typed(linears, z, onehot):
        """Every type's projection of z (b, h, w, l, c), each agent's own
        selected by the one-hot of its type (b, l, T)."""
        stack = torch.stack([lin(z) for lin in linears], dim=-2)
        return (stack * onehot[:, None, None, :, :, None]).sum(dim=-2)

    def _heads(self, z):
        b, h, w, l, _ = z.shape
        return z.reshape(b, h, w, l, self.heads, self.dim_head).permute(
            0, 4, 1, 2, 3, 5)                      # b m h w l c

    def forward(self, x, mask, prior_encoding, generator=None):
        """x: (B, L, H, W, C); mask: (B, H, W, L, 1); prior_encoding:
        (B, L, H, W, 3) [velocity, dt, type] -> (B, L, H, W, C)."""
        t = x.permute(0, 2, 3, 1, 4)               # b h w l c
        types = prior_encoding[:, :, 0, 0, 2].long()
        onehot = F.one_hot(types, self.num_types).to(t.dtype)
        q = self._heads(self._typed(self.q_linears, t, onehot)).float()
        k = self._heads(self._typed(self.k_linears, t, onehot)).float()
        v = self._heads(self._typed(self.v_linears, t, onehot))

        # relation (type_i, type_j) -> index type_i * T + type_j
        rel = types[:, :, None] * self.num_types + types[:, None, :]
        rel_onehot = F.one_hot(rel, self.num_relations).float()
        w_att = torch.einsum("bijr,rmpq->bmijpq", rel_onehot,
                             self.relation_att.float())
        w_msg = torch.einsum("bijr,rmpq->bmijpq", rel_onehot,
                             self.relation_msg.float())

        qa = torch.einsum("bmhwip,bmijpq->bmhwijq", q, w_att)
        att = torch.einsum("bmhwijq,bmhwjq->bmhwij", qa, k)
        att = att * self.dim_head ** -0.5
        # the reference's mask broadcast lands on the *query* axis: a masked
        # agent's own row is suppressed, its keys are not (-1e9, not -inf,
        # so that row is a finite uniform distribution)
        q_mask = mask[..., 0][:, None, :, :, :, None]    # b 1 h w l 1
        att = att + torch.where(q_mask > 0, 0.0, NEG_INF)
        att = F.softmax(att, dim=-1)

        v_msg = torch.einsum("bmijpc,bmhwjp->bmhwijc", w_msg, v.float())
        out = torch.einsum("bmhwij,bmhwijc->bmhwic", att, v_msg)
        b, m, h, w, l, c = out.shape
        out = out.permute(0, 2, 3, 4, 1, 5).reshape(b, h, w, l, m * c)
        out = self._typed(self.a_linears, out.to(x.dtype), onehot)
        out = dropout(out, self.dropout, self.training, generator)
        return out.permute(0, 3, 1, 2, 4)
