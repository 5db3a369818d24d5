"""ARG, Actor Relation Graphs (port of din_tpu/heads/arg.py; reference
gcn_model.py:6-87, duplicated in infer_module/ARG_infer_module.py:6-91).

``num_graph`` relation graphs over a token set: per graph theta/phi
embeddings (NFG -> NFR, with bias), scaled dot-product affinity, a distance
mask (box centres farther apart than ``pos_threshold * OW`` feature pixels
are not related: -inf before the row softmax), the graph convolution
(NFG -> NFG, no bias), a per-graph LayerNorm and ReLU; the graphs are
summed.  The module keeps the reference's per-graph ModuleLists
(``fc_rn_theta_list.{g}``, ``fc_rn_phi_list.{g}``, ``fc_gcn_list.{g}``,
``nl_gcn_list.{g}``), so reference keys load by name, and stacks their
weights on a graph axis in the forward to compute all graphs in one
einsum, as din_tpu does.  Volleyball normalises each graph over [T*N, NFG]
jointly, the collective model over [NFG] (gcn_model.py:27-30); the
LayerNorm computes the two-pass variance as din_tpu's does.

``token_mask`` (True = a real actor) relates only pairs of real tokens; a
padded token's row is all masked, and its softmax row, NaN in din_tpu
until it zeroes it, is 0 here and never NaN, so its gradient is finite.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from din_tpu_torch.nn.layers import kaiming_linear
from din_tpu_torch.ops.image import calc_pairwise_distance_3d


class GCNModule(nn.Module):
    """One ARG layer over [B', Nt, NFG] token sets (volleyball: B' = B,
    Nt = T*N).  ``ln_shape`` is the LayerNorm's normalised shape: (T*N,
    NFG) for volleyball, (NFG,) for the collective model."""

    def __init__(self, num_features_gcn: int, num_features_relation: int,
                 num_graph: int, pos_threshold: float, out_w: int,
                 ln_shape: Sequence[int], generator: torch.Generator):
        super().__init__()
        nfg, nfr = num_features_gcn, num_features_relation
        self.nfr = nfr
        self.pos_threshold = pos_threshold
        self.out_w = out_w
        self.ln_shape = tuple(ln_shape)
        self.fc_rn_theta_list = nn.ModuleList(
            kaiming_linear(nfg, nfr, generator) for _ in range(num_graph))
        self.fc_rn_phi_list = nn.ModuleList(
            kaiming_linear(nfg, nfr, generator) for _ in range(num_graph))
        self.fc_gcn_list = nn.ModuleList(
            kaiming_linear(nfg, nfg, generator, bias=False)
            for _ in range(num_graph))
        self.nl_gcn_list = nn.ModuleList(
            nn.LayerNorm(self.ln_shape) for _ in range(num_graph))
        self.register_load_state_dict_pre_hook(self._squeeze_ln)

    def _squeeze_ln(self, module, state_dict, prefix, *args) -> None:
        """din_tpu's exporter writes a LayerNorm over [NFG] as [1, NFG]
        (its stacked parameter's slice); the reference's is [NFG]: both
        load."""
        for k in list(state_dict):
            if k.startswith(prefix + "nl_gcn_list.") and \
                    tuple(state_dict[k].shape) == (1,) + self.ln_shape:
                state_dict[k] = state_dict[k].reshape(self.ln_shape)

    @staticmethod
    def _stack(modules: nn.ModuleList, name: str) -> torch.Tensor:
        return torch.stack([getattr(m, name) for m in modules])

    def forward(self, graph_features: torch.Tensor, boxes: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """graph_features [B, Nt, NFG]; boxes [B, Nt, 4] in feature-map
        pixels; token_mask [B, Nt] or None.  Returns (features [B, Nt,
        NFG], the last graph's relation matrix [B, Nt, Nt])."""
        x = graph_features
        # distance mask over box centres (gcn_model.py:48-56)
        boxes = boxes.float()
        pos = torch.stack([(boxes[..., 0] + boxes[..., 2]) / 2.0,
                           (boxes[..., 1] + boxes[..., 3]) / 2.0], dim=-1)
        mask = calc_pairwise_distance_3d(pos, pos) > (
            self.pos_threshold * self.out_w)
        if token_mask is not None:
            mask = mask | ~(token_mask[:, :, None] & token_mask[:, None, :])
        mask = mask[:, None]                                   # [B,1,Nt,Nt]

        theta = torch.einsum(
            "bnf,grf->bgnr", x, self._stack(self.fc_rn_theta_list, "weight")
        ) + self._stack(self.fc_rn_theta_list, "bias")[None, :, None]
        phi = torch.einsum(
            "bnf,grf->bgnr", x, self._stack(self.fc_rn_phi_list, "weight")
        ) + self._stack(self.fc_rn_phi_list, "bias")[None, :, None]
        sim = torch.einsum("bgnr,bgmr->bgnm", theta, phi) / math.sqrt(
            self.nfr)
        sim = sim.float().masked_fill(mask, -math.inf)
        # a row with no related token: softmax of zeros, then zeroed
        empty = mask.all(dim=-1, keepdim=True)
        relation = torch.softmax(sim.masked_fill(empty, 0.0), dim=-1)
        relation = relation.masked_fill(empty, 0.0)

        agg = torch.einsum("bgnm,bmf->bgnf", relation.to(x.dtype), x)
        out = torch.einsum("bgnf,ghf->bgnh", agg,
                           self._stack(self.fc_gcn_list, "weight"))
        # per-graph LayerNorm, ReLU, the sum over graphs
        dims = tuple(range(-len(self.ln_shape), 0))
        o32 = out.float()
        var, mean = torch.var_mean(o32, dim=dims, keepdim=True,
                                   unbiased=False)
        normed = (o32 - mean) * torch.rsqrt(var + 1e-5)
        scale = self._stack(self.nl_gcn_list, "weight")
        bias = self._stack(self.nl_gcn_list, "bias")
        if len(self.ln_shape) == 1:
            scale, bias = scale[:, None], bias[:, None]
        normed = torch.relu(normed * scale[None] + bias[None]).to(x.dtype)
        return normed.sum(dim=1), relation[:, -1]
