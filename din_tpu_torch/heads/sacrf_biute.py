"""SACRF + BiUTE (port of din_tpu/heads/sacrf_biute.py; reference
infer_module/SACRF_BiUTE_infer_module.py:99-414).

SACRF refines unary action potentials ``Q_u = f_u(PE(x))`` (``PE`` the
boxes' sine encoding) with pairwise potentials from a multi-head *spatial*
attention over clique partitions of a frame's actors (cliques of 2, 3, 6
and 12, mixed by learned weights ``w``) and a multi-head *temporal*
attention along each actor's track, and halts per actor by accumulated
halting probability (adaptive computation time).  BiUTE pools the final
actor states into a group descriptor: a learned-weighted sum over the
actors beside their max.

As in din_tpu, the reference's data-dependent loop of at most 10
iterations is a fixed 10-iteration recursion with halting masks; the step
returned is ``v_stop``, the iteration where every actor of the clip has
halted (else the 10th), and the halting loss ``R(t) + N(t)`` is computed
from the same trajectory.  In training each iteration recomputes both
attentions with fresh dropout masks (rate 0.1, the modules' own seeded
generators), as the reference does; in eval they are computed once.

The 8 heads of an attention block keep the reference's modules
(``attlist.{i}.theta``, ``.phi``, ``.fun_g``) and names (``W_out``,
``layernorm1``, ``FFN_linear1``, ``FFN_linear2``, the spatial block's
``w``); the forward stacks the heads' weights into one projection per
role, and projects every actor once for all four clique partitions (the
projections are per actor, so each partition reads the same values).  The
attention is unnormalised (no softmax), scaled by 1/sqrt(C).  BiUTE's
optional bidirectional temporal attention (``use_biute_attention``, off in
din_tpu, whose reference computes it and discards it,
SACRF_BiUTE_infer_module.py:414) is not ported.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from din_tpu_torch.heads.positional import boxes_position_embedding
from din_tpu_torch.nn.layers import SeededDropout, kaiming_linear


class SelfAtt(nn.Module):
    """One head's projections (SACRF_BiUTE_infer_module.py:122-147); the
    attention itself is computed by ``_AttBlock`` for all heads at once."""

    def __init__(self, in_dim: int, latent_dim: int, out_dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.theta = kaiming_linear(in_dim, latent_dim, generator, bias=False)
        self.phi = kaiming_linear(in_dim, latent_dim, generator, bias=False)
        self.fun_g = kaiming_linear(in_dim, out_dim, generator, bias=False)


class _AttBlock(nn.Module):
    """The modules both attention blocks share: 8 heads of C/8 features,
    ``W_out``, ``layernorm1`` and the FFN."""

    def __init__(self, in_dim: int, num_att: int,
                 generator: torch.Generator):
        super().__init__()
        self.in_dim = in_dim
        self.num_att = num_att
        latent = in_dim // num_att
        self.attlist = nn.ModuleList(
            SelfAtt(in_dim, latent, latent, generator)
            for _ in range(num_att))
        self.W_out = kaiming_linear(in_dim, in_dim, generator, bias=False)
        self.layernorm1 = nn.LayerNorm(in_dim)
        self.FFN_linear1 = kaiming_linear(in_dim, in_dim, generator)
        self.FFN_linear2 = kaiming_linear(in_dim, in_dim, generator)

    def _project(self, x: torch.Tensor):
        """x [..., C] -> theta, phi, g [..., heads, C/heads]."""
        def proj(name):
            w = torch.cat([getattr(a, name).weight for a in self.attlist])
            return torch.matmul(x, w.t()).unflatten(-1, (self.num_att, -1))
        return proj("theta"), proj("phi"), proj("fun_g")

    def _attend(self, theta, phi, g, group: int) -> torch.Tensor:
        """[M, heads, L] projections of M tokens in sets of ``group`` ->
        the heads' attention outputs concatenated, [M, C]: per set and
        head (theta phi^T / sqrt(C)) g."""
        M, NH, L = theta.shape

        def sets(t):
            return t.reshape(M // group, group, NH, L).transpose(1, 2)

        att = torch.matmul(sets(theta), sets(phi).transpose(-1, -2)) / \
            math.sqrt(self.in_dim)
        out = torch.matmul(att, sets(g))                 # [M/group,NH,g,L]
        return out.transpose(1, 2).reshape(M, NH * L)

    def _residual_ffn(self, heads, x, drop, ffn_drop) -> torch.Tensor:
        heads = self.layernorm1(drop(self.W_out(heads)) + x)
        return self.FFN_linear2(ffn_drop(torch.relu(
            self.FFN_linear1(heads))))


class SpatialAtt(_AttBlock):
    """Multi-head attention within clique partitions of each frame's
    actors, the partitions mixed by the learned weights ``w``
    (SACRF_BiUTE_infer_module.py:150-206).  x [B,T,N,C] -> [B,T,N,C]."""

    def __init__(self, in_dim: int, generator: torch.Generator,
                 num_att: int = 8, dropout: float = 0.1,
                 cliques: Sequence[int] = (2, 3, 6, 12), seed: int = 0):
        super().__init__(in_dim, num_att, generator)
        self.cliques = tuple(cliques)
        self.w = nn.Parameter(torch.ones(len(self.cliques)))
        self.dropout = SeededDropout(dropout, seed)
        self.ffn_dropout = SeededDropout(dropout, seed + 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, N, C = x.shape
        proj = [p.reshape(B * T * N, self.num_att, -1)
                for p in self._project(x)]
        multi = [self._residual_ffn(
            self._attend(*proj, clique).reshape(B, T, N, C), x,
            self.dropout, self.ffn_dropout) for clique in self.cliques]
        return torch.einsum("btncx,x->btnc", torch.stack(multi, dim=-1),
                            self.w.to(x.dtype))


class TemporalAtt(_AttBlock):
    """Multi-head attention along each actor's track
    (SACRF_BiUTE_infer_module.py:209-258).  x [B,T,N,C] -> [B,T,N,C]."""

    def __init__(self, in_dim: int, generator: torch.Generator,
                 num_att: int = 8, dropout: float = 0.1, seed: int = 0):
        super().__init__(in_dim, num_att, generator)
        self.dropout1 = SeededDropout(dropout, seed)
        self.FFN_dropout = SeededDropout(dropout, seed + 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, N, C = x.shape
        xt = x.transpose(1, 2).reshape(B * N * T, C)
        heads = self._attend(*self._project(xt), T)
        y = self._residual_ffn(heads, xt, self.dropout1, self.FFN_dropout)
        return y.reshape(B, N, T, C).transpose(1, 2)


class SACRF(nn.Module):
    """features [B,T,N,C], boxes [B,T,N,4] -> (Q_hat action posteriors
    [B,T,N,A], C_v actor states [B,T,N,C], the halting loss, a scalar)
    (SACRF_BiUTE_infer_module.py:261-337).  N must divide by every
    clique size."""

    def __init__(self, in_dim: int, num_actions: int,
                 image_size: Tuple[int, int], out_size: Tuple[int, int],
                 generator: torch.Generator, num_att: int = 8,
                 dropout: float = 0.1, cliques: Sequence[int] = (2, 3, 6, 12),
                 max_iters: int = 10, seed: int = 0):
        super().__init__()
        A = num_actions
        self.image_size = tuple(image_size)
        self.out_size = tuple(out_size)
        self.max_iters = max_iters
        self.f_u = kaiming_linear(in_dim, A, generator)
        self.spatial_att = SpatialAtt(in_dim, generator, num_att, dropout,
                                      cliques, seed=seed)
        self.temporal_att = TemporalAtt(in_dim, generator, num_att, dropout,
                                        seed=seed + 2)
        self.f_spatil_att = kaiming_linear(in_dim, A, generator, bias=False)
        self.f_temporal_att = kaiming_linear(in_dim, A, generator, bias=False)
        self.compatible_trans_s = kaiming_linear(A, A, generator, bias=False)
        self.compatible_trans_t = kaiming_linear(A, A, generator, bias=False)
        self.halt_fc = kaiming_linear(in_dim, 1, generator)

    def forward(self, features: torch.Tensor, boxes: torch.Tensor):
        B, T, N, C = features.shape
        V = self.max_iters
        features = boxes_position_embedding(features, boxes, self.image_size,
                                            self.out_size)
        q_u = self.f_u(features)
        # with dropout active every iteration draws its own masks; else
        # the attentions (of loop-invariant features) are computed once
        stochastic = self.training and self.spatial_att.dropout.p > 0
        halt_prob = features.new_zeros((B, T, N), dtype=torch.float32)
        halt_mask = torch.zeros((B, T, N), dtype=torch.bool,
                                device=features.device)
        halt_iter = torch.full((B, T, N), V + 1, dtype=torch.long,
                               device=features.device)
        c_v = features
        q_hats, c_vs = [], []
        for v in range(V):
            if v == 0 or stochastic:
                s_ft = self.spatial_att(features)
                t_ft = self.temporal_att(features)
                q_p = self.compatible_trans_s(self.f_spatil_att(s_ft)) + \
                    self.compatible_trans_t(self.f_temporal_att(t_ft))
                q_hat_v = torch.softmax((q_u + q_p).float(), dim=-1)
                c_temp = s_ft + t_ft
            # halting recursion (SACRF_BiUTE_infer_module.py:302-335)
            c_v = torch.where(halt_mask[..., None], c_v, c_temp)
            h = torch.sigmoid(self.halt_fc(c_v)[..., 0].float())
            halt_prob_new = halt_prob + h
            newly = (halt_prob_new >= 1.0) & ~halt_mask
            halt_iter = torch.where(newly, v + 1, halt_iter)
            halt_mask = halt_mask | newly
            # a cell that just crossed keeps its pre-crossing probability,
            # as the reference's freeze does
            halt_prob = torch.where(halt_mask, halt_prob, halt_prob_new)
            q_hats.append(q_hat_v)
            c_vs.append(c_v)

        # the reference leaves the loop once every cell has halted; it
        # returns Q_hat and C_v of that iteration, v_stop
        all_halted = halt_mask.reshape(B, -1).all(dim=-1)
        v_stop = torch.where(
            all_halted, halt_iter.clamp(max=V).reshape(B, -1).amax(dim=-1),
            torch.full_like(all_halted, V, dtype=torch.long))   # [B]
        rows = torch.arange(B, device=features.device)
        q_hat = torch.stack(q_hats)[v_stop - 1, rows]
        c_v = torch.stack(c_vs)[v_stop - 1, rows]
        # R(t) + N(t): the counter counts the iterations spent halted up
        # to v_stop, inclusive (SACRF_BiUTE_infer_module.py:331-335)
        counter = torch.where(
            halt_mask, (v_stop[:, None, None] - halt_iter + 1).clamp(min=0),
            0)
        n_t = V - counter + 1
        n_t = torch.where(n_t == V + 1, V, n_t)
        halt_loss = (1.0 - halt_prob).sum() + n_t.float().sum()
        return q_hat, c_v, halt_loss


class BiUTE(nn.Module):
    """features [B,T,N,C] -> the group descriptor [B,T,2C]: the actors
    summed with learned weights (``q``), beside their max
    (SACRF_BiUTE_infer_module.py:340-414)."""

    def __init__(self, in_dim: int, num_boxes: int,
                 generator: torch.Generator):
        super().__init__()
        self.q = kaiming_linear(in_dim, num_boxes, generator, bias=False)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        g_weight = self.q(features).sum(dim=-1)              # [B,T,N]
        g = torch.einsum("btn,btnc->btc", g_weight, features)
        return torch.cat([g, features.amax(dim=2)], dim=-1)
