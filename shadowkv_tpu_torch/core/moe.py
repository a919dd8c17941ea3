"""Mixture-of-experts layer on one device's share of an expert-parallel
deployment (DeepSeek-V3's block, ``DeepseekV3TopkRouter`` and
``DeepseekV3MoE``, as K-EXAONE's ``exaone_moe`` configuration uses it).

The router runs in float32 over every routed expert: ``s = sigmoid(x @
W_r)``; the chosen experts are the top ``num_experts_per_tok`` of ``s +
e_bias``; their weights are ``s[chosen] / (sum s[chosen] + 1e-20)`` (when
``norm_topk_prob``) times ``routed_scaling_factor``. This device holds the
routed experts ``ModelConfig.held`` and adds their part of the result, in
float32, rounded once to the model dtype; then the shared expert, which
every device holds, once. The absent experts' part is another device's
(the exchange between devices is not part of this module). Each expert is
a SwiGLU MLP with the fused gate/up projection of ``core/layers.py``.

Two paths, one function:

- ``static=True`` (the decode step, captured as a CUDA graph): the masked
  pass over the held experts, every token through each held expert, each
  output weighted by the token's weight for that expert (0 when it did not
  choose it): static shapes, exact;
- ``static=False`` (the prefill): the tokens grouped by held expert, each
  expert run on the tokens that chose it alone (the grouping reads the
  choices on the host).

Under a profiler the router is the phase ``route`` and the experts (held
and shared) the phase ``experts`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from shadowkv_tpu_torch.core.wquant import mat
from shadowkv_tpu_torch.utils import profiling as prof

ROUTE_EPS = 1e-20  # DeepSeek-V3's guard of the weights' denominator


class MoELayer(NamedTuple):
    """One MoE layer's weights (views of ``MoEParams``)."""

    router: torch.Tensor  # [D, E] f32
    e_bias: torch.Tensor  # [E] f32
    w_gate_up: torch.Tensor  # [Eh, D, 2 I] the held experts
    w_down: torch.Tensor  # [Eh, I, D]
    shared_gate_up: torch.Tensor  # [D, 2 Is]
    shared_down: torch.Tensor  # [Is, D]
    held: torch.Tensor  # [Eh] int64 ids of the held experts


class MoEParams(NamedTuple):
    """The MoE layers' weights, stacked over those layers in order
    [Lm, ...]; the held experts in ``ModelConfig.held`` order."""

    router: torch.Tensor
    e_bias: torch.Tensor
    w_gate_up: torch.Tensor
    w_down: torch.Tensor
    shared_gate_up: torch.Tensor
    shared_down: torch.Tensor
    held: torch.Tensor
    layers: tuple  # the model layers the stacks hold, in order

    def layer(self, i: int) -> MoELayer:
        """Model layer ``i``'s weights (views)."""
        j = self.layers.index(i)
        return MoELayer(*(t[j] for t in self[:6]), self.held)

    def to(self, device) -> "MoEParams":
        return MoEParams(*(t.to(device) for t in self[:7]), self.layers)


def route(model, lp: MoELayer, x: torch.Tensor):
    """The router of tokens x [N, D]: (chosen expert ids [N, k] int64,
    their weights [N, k] f32)."""
    s = torch.sigmoid(x.float() @ lp.router.float())
    top = (s + lp.e_bias.float()).topk(model.num_experts_per_tok,
                                       dim=-1).indices
    w = s.gather(-1, top)
    if model.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + ROUTE_EPS)
    return top, w * model.routed_scaling_factor


def _swiglu(x: torch.Tensor, w_gate_up, w_down) -> torch.Tensor:
    gate, up = torch.chunk(mat(x, w_gate_up), 2, dim=-1)
    return mat(F.silu(gate.float()).to(x.dtype) * up, w_down)


def moe(model, lp: MoELayer, x: torch.Tensor, static: bool):
    """The layer on x [B, S, D]: (output [B, S, D] in x's dtype, the
    chosen expert ids [B, S, k] int64)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    with prof.span(prof.ROUTE, x.device):
        top, w = route(model, lp, x2)
        # [N, k, Eh]: the held expert each choice names, if any
        hit = top[..., None] == lp.held
    with prof.span(prof.EXPERTS, x.device):
        if static:
            hw = (hit * w[..., None]).sum(1)  # [N, Eh] 0 where not chosen
            gate, up = torch.chunk(torch.matmul(x2, lp.w_gate_up), 2, dim=-1)
            y = torch.matmul(F.silu(gate.float()).to(x.dtype) * up,
                             lp.w_down)  # [Eh, N, D]
            acc = torch.einsum("end,ne->nd", y.float(), hw)
        else:
            acc = torch.zeros(x2.shape, dtype=torch.float32, device=x.device)
            for j in range(lp.held.shape[0]):
                tok, slot = hit[..., j].nonzero(as_tuple=True)
                if tok.numel():
                    y = _swiglu(x2[tok], lp.w_gate_up[j], lp.w_down[j])
                    acc.index_add_(0, tok, y.float() * w[tok, slot, None])
        out = acc.to(x.dtype) + _swiglu(x2, lp.shared_gate_up,
                                        lp.shared_down)
    return out.view(shape), top.view(*shape[:-1], -1)
