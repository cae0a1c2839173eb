"""Mixture-of-Experts layer (counterpart of paddle_tpu/incubate/moe.py).

The GShard formulation of the reference (Lepikhin et al. 2020, §2):
top-k gating (k = 1 or 2) computed in float32, a fixed expert capacity
C = ceil(S / E * capacity_factor * k), one-hot dispatch and combine
tensors [S, E, C], and the expert FFNs as einsums batched over the
experts. A token over its expert's capacity is dropped (its combine
weight is 0; the surrounding block's residual carries it). Second
choices are placed after every first choice of the same expert. The
load-balancing loss E * sum_e mean_prob_e * frac_tokens_e is `l_aux`.

All experts are local on one card, as the reference's layer off a mesh;
expert parallelism over an "ep" mesh axis belongs to the distributed
slice. Every step is an op of the tensor surface (matmul, cast, argmax,
sum, mean, cumsum, clip, einsum, one_hot, softmax), so the layer records
into a static program and runs inside a captured train step alike.
"""
from __future__ import annotations

import math

import torch

from .. import tensor as P
from ..nn import functional as F
from ..nn.layer_base import Layer
from ..static.program import Variable

__all__ = ["MoELayer"]


def _col(g):
    """[S] -> [S, 1, 1]."""
    return P.unsqueeze(P.unsqueeze(g, -1), -1)


class MoELayer(Layer):
    """Position-wise MoE FFN: y[token] = sum over its chosen experts of
    gate * expert(token).

    Args:
        d_model: token width.
        d_hidden: an expert FFN's hidden width.
        num_experts: the experts E.
        top_k: experts a token (1 or 2).
        capacity_factor: the slack over the balanced S * k / E.
        activation: the experts' nonlinearity, a name in nn.functional
            (gelu: the exact form, as the reference's F.gelu default).
        normalize_gates: the k gate values renormalised to sum to 1.
        generator: the torch.Generator the weights are drawn from.

    Parameters: `gate_weight` [d_model, E], `w1` [E, d_model, d_hidden],
    `b1` [E, d_hidden], `w2` [E, d_hidden, d_model], `b2` [E, d_model];
    buffer `l_aux_value` (0-d), the last forward's load-balancing loss.
    """

    def __init__(self, d_model, d_hidden, num_experts, top_k=2,
                 capacity_factor=1.25, activation="gelu",
                 normalize_gates=True, name=None, generator=None):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError("top_k must be 1 or 2, got %r" % (top_k,))
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = float(capacity_factor)
        self.activation = activation
        self.normalize_gates = normalize_gates
        E = num_experts
        self.gate_weight = self.create_parameter(
            shape=[d_model, E], generator=generator)
        self.w1 = self.create_parameter(shape=[E, d_model, d_hidden],
                                        generator=generator)
        self.b1 = self.create_parameter(shape=[E, d_hidden], is_bias=True,
                                        generator=generator)
        self.w2 = self.create_parameter(shape=[E, d_hidden, d_model],
                                        generator=generator)
        self.b2 = self.create_parameter(shape=[E, d_model], is_bias=True,
                                        generator=generator)
        self.register_buffer("l_aux_value",
                             torch.zeros((), dtype=torch.float32))
        self._l_aux_live = None
        # tokens over capacity in the last forward (first and second
        # choices that were dropped), a 0-d int64 tensor on the device
        self.dropped = None

    def capacity(self, n_tokens):
        return max(1, int(math.ceil(n_tokens / self.num_experts
                                    * self.capacity_factor * self.top_k)))

    @property
    def l_aux(self):
        """The load-balancing loss of the latest forward. Eagerly, and
        inside a train step's body, the live tensor, which backpropagates
        into the gate; after a train step the `l_aux_value` buffer, which
        the step writes (after its non-finite guard, as a batch norm's
        statistics), so that it reads as a number after a captured step.
        The step's live tensor is dropped when its body ends."""
        live = F._held(self)
        if live is None:
            live = self._l_aux_live
        return self.l_aux_value if live is None else live

    def _place(self, mask, offset, C):
        """(1-based position of each token in its chosen expert's queue,
        0/1 kept within capacity) for one choice's one-hot `mask` [S, E],
        behind `offset` earlier tokens of the expert."""
        pos = P.cumsum(mask, axis=0)
        if offset is not None:
            pos = pos + offset
        pos = pos * mask
        keep = P.cast(pos <= float(C), "float32") * mask
        slot = P.cast(P.sum(pos, axis=-1), "int64") - 1
        return slot, P.sum(keep, axis=-1)

    def forward(self, x):
        shape = tuple(x.shape)
        M, E = self.d_model, self.num_experts
        S = 1
        for s in shape[:-1]:
            S *= int(s)
        C = self.capacity(S)
        xs = P.reshape(x, [S, M])

        # the gate, in float32
        logits = P.matmul(P.cast(xs, "float32"),
                          P.cast(self.gate_weight, "float32"))
        probs = F.softmax(logits, axis=-1)                      # [S, E]
        idx1 = P.argmax(probs, axis=-1)                         # [S]
        mask1 = F.one_hot(idx1, E)                              # [S, E]
        g1 = P.sum(probs * mask1, axis=-1)                      # [S]

        # the load-balancing loss, differentiable through probs
        me = P.mean(probs, axis=0)
        ce = P.mean(mask1, axis=0)
        aux = P.sum(me * ce) * float(E)
        # eagerly the layer keeps the live loss; inside a train step's
        # body the step does, until the body ends
        self._l_aux_live = None if F._hold(self, aux) else aux
        if not isinstance(aux, Variable):
            # a static program keeps the loss symbolic: nothing to write
            with torch.no_grad():
                F._set_running(self.l_aux_value,
                               aux.detach().to(self.l_aux_value.dtype))

        if self.top_k == 2:
            probs2 = probs * (1.0 - mask1)
            idx2 = P.argmax(probs2, axis=-1)
            mask2 = F.one_hot(idx2, E)
            g2 = P.sum(probs2 * mask2, axis=-1)
            if self.normalize_gates:
                denom = g1 + g2 + 1e-9
                g1, g2 = g1 / denom, g2 / denom

        # capacity: each token's slot in its expert's queue
        slot1, in1 = self._place(mask1, None, C)
        combine = _col(g1 * in1) \
            * P.unsqueeze(mask1, -1) \
            * P.unsqueeze(F.one_hot(P.clip(slot1, 0, C - 1), C), 1)
        kept = P.sum(in1)
        if self.top_k == 2:
            # second choices go after every first choice of their expert
            count1 = P.sum(mask1, axis=0, keepdim=True)         # [1, E]
            slot2, in2 = self._place(mask2, count1, C)
            combine = combine + _col(g2 * in2) \
                * P.unsqueeze(mask2, -1) \
                * P.unsqueeze(F.one_hot(P.clip(slot2, 0, C - 1), C), 1)
            kept = kept + P.sum(in2)
        self.dropped = (S * self.top_k) - P.cast(kept, "int64")

        combine = P.cast(combine, x.dtype)                      # [S, E, C]
        dispatch = P.cast(combine > 0, x.dtype)

        # dispatch -> the experts' FFNs -> combine
        dispatched = P.einsum("sec,sm->ecm", dispatch, xs)
        h = P.einsum("ecm,emh->ech", dispatched, self.w1) \
            + P.unsqueeze(self.b1, 1)
        h = getattr(F, self.activation)(h)
        y = P.einsum("ech,ehm->ecm", h, self.w2) + P.unsqueeze(self.b2, 1)
        out = P.einsum("sec,ecm->sm", combine, y)
        return P.reshape(out, shape)
