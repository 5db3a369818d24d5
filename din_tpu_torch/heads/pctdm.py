"""PCTDM, the Participation-Contributed Temporal Dynamic Model (port of
din_tpu/heads/pctdm.py; reference infer_module/pctdm_infer_module.py:9-133).

The players of a frame are a sequence: a BiLSTM over them, "early pooling"
(the elementwise max of the forward and backward states), then per team of
N/2 players a context-conditioned attention and a one-to-all intra-group
LSTM whose last state summarises the team; the two summaries are
concatenated -> [B*T, 2*hidden].  The attention weights and the
intra-group LSTM are shared by both teams.

**One trainable bias per LSTM direction.**  A reference ``nn.LSTM`` holds
``bias_ih_l0`` and ``bias_hh_l0`` and adds both in its cell; din_tpu's
``TorchLSTM`` trains their sum as one bias (its import adds the two, its
export writes ``bias_ih = bias``, ``bias_hh = 0``).  With two trainable
biases Adam would move their sum about twice as far per step, so the port
follows din_tpu: ``bias_ih_l0`` is the one trainable bias and
``bias_hh_l0`` is a buffer held at zero.  The state_dict keys are thus the
reference's (a port file is a reference file with ``bias_hh_l0 = 0``), and
a load-state-dict pre-hook folds a file's ``bias_hh_l0`` into
``bias_ih_l0`` and zeroes it, so reference files load strictly and
compute the same gates.  Adam moments of the two reference biases are
halved and summed onto ``bias_ih_l0`` (``nn/ref_import.py``
``load_reference_optimizer``, as din_tpu/nn/ref_import.py:350-356).

The recurrence is a loop of float32 matmuls (input projection of all steps
at once, then ``h @ W_hh^T`` per step in torch gate order i, f, g, o), not
cuDNN's RNN, which would run in TF32 under the card's default flags; plain
float32 matmuls run in IEEE float32 there
(``torch.backends.cuda.matmul.allow_tf32`` is False by default).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from din_tpu_torch.nn.layers import kaiming_linear


class TorchLSTM(nn.Module):
    """Unidirectional one-layer LSTM over axis 1 of [B, L, C] with torch's
    semantics and parameter names (``weight_ih_l0``, ``weight_hh_l0``,
    ``bias_ih_l0``; ``bias_hh_l0`` a zero buffer, see the module
    docstring), initialised uniform(-1/sqrt(H), 1/sqrt(H)) as torch's."""

    directions: Tuple[str, ...] = ("",)

    def __init__(self, input_size: int, hidden: int,
                 generator: torch.Generator):
        super().__init__()
        self.hidden = hidden
        bound = 1.0 / math.sqrt(hidden)

        def uniform(*shape):
            return nn.Parameter(torch.empty(shape).uniform_(
                -bound, bound, generator=generator))

        for sfx in self.directions:
            self.register_parameter(f"weight_ih_l0{sfx}",
                                    uniform(4 * hidden, input_size))
            self.register_parameter(f"weight_hh_l0{sfx}",
                                    uniform(4 * hidden, hidden))
            self.register_parameter(f"bias_ih_l0{sfx}", uniform(4 * hidden))
            self.register_buffer(f"bias_hh_l0{sfx}", torch.zeros(4 * hidden))
        self.register_load_state_dict_pre_hook(self._fold_biases)

    def _fold_biases(self, module, state_dict, prefix, *args) -> None:
        """A file's two biases -> ``bias_ih_l0 = bias_ih + bias_hh``,
        ``bias_hh_l0 = 0`` (the same gates)."""
        for sfx in self.directions:
            ih, hh = (f"{prefix}bias_{k}_l0{sfx}" for k in ("ih", "hh"))
            if ih in state_dict and hh in state_dict:
                state_dict[ih] = state_dict[ih] + state_dict[hh]
                state_dict[hh] = torch.zeros_like(state_dict[hh])

    def _run(self, x: torch.Tensor, sfx: str) -> torch.Tensor:
        """[B, L, C] -> the hidden states [B, L, H] of direction ``sfx``."""
        w_hh = getattr(self, f"weight_hh_l0{sfx}")
        bias = getattr(self, f"bias_ih_l0{sfx}")
        xw = torch.matmul(x, getattr(self, f"weight_ih_l0{sfx}").t())
        h = c = x.new_zeros((x.shape[0], self.hidden))
        ys = []
        for t in range(x.shape[1]):
            gates = xw[:, t] + torch.matmul(h, w_hh.t()) + bias
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys, dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, "")


class BiTorchLSTM(TorchLSTM):
    """Bidirectional: [forward ; backward] states per position, the
    backward direction's parameters suffixed ``_reverse`` as in
    ``nn.LSTM(bidirectional=True)``."""

    directions = ("", "_reverse")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bwd = self._run(torch.flip(x, dims=(1,)), "_reverse")
        return torch.cat([self._run(x, ""), torch.flip(bwd, dims=(1,))],
                         dim=-1)


class PCTDM(nn.Module):
    """x [B, T, N, NFB] -> [B*T, 2*hidden] team descriptors.  Module names
    are the reference's: ``Bi_Lstm``, ``att_source_weights.0``,
    ``att_context_weights.0``, ``att_extra_weights.0``,
    ``Intra_Group_LSTM``."""

    def __init__(self, num_players: int, input_size: int,
                 generator: torch.Generator, hidden: int = 1000,
                 num_groups: int = 2):
        super().__init__()
        self.num_players = num_players
        self.hidden = hidden
        self.num_groups = num_groups
        H = hidden
        self.Bi_Lstm = BiTorchLSTM(input_size, H, generator)
        self.att_source_weights = nn.Sequential(
            kaiming_linear(H, H, generator))
        self.att_context_weights = nn.Sequential(
            kaiming_linear(H, H, generator))
        self.att_extra_weights = nn.Sequential(kaiming_linear(H, 1, generator))
        self.Intra_Group_LSTM = TorchLSTM(H, H, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, N, NFB = x.shape
        if N != self.num_players:
            raise ValueError(f"PCTDM takes {self.num_players} players, got "
                             f"{N}")
        H = self.hidden
        lstm_out = self.Bi_Lstm(x.reshape(B * T, N, NFB))
        # early pooling (pctdm_infer_module.py:92-96)
        pooled = torch.maximum(lstm_out[..., :H], lstm_out[..., H:])
        # context-conditioned attention per team
        # (pctdm_infer_module.py:52-67,100-116)
        context = self.att_context_weights(pooled.mean(dim=1))[:, None]
        per_group = N // self.num_groups
        teams = []
        for g in range(self.num_groups):
            xg = pooled[:, g * per_group:(g + 1) * per_group]  # [BT, n, H]
            e = self.att_extra_weights(torch.tanh(
                self.att_source_weights(xg) + context))
            gamma = torch.softmax(e[..., 0].float(), dim=-1)[..., None]
            # one-to-all LSTM; the last node summarises the team
            teams.append(self.Intra_Group_LSTM(
                xg + xg * gamma.to(xg.dtype))[:, -1])
        return torch.cat(teams, dim=-1)
