"""Mixture-of-Experts with expert parallelism over an "expert" mesh axis
(counterpart of `bigdl_tpu/parallel/moe.py`).

Top-1 (Switch) or top-2 (GShard) routing with per-group capacity. The
dense `forward` runs every expert on every token and is the reference the
capacity paths match where nothing drops. `dense_capacity_apply` is the
single-device oracle with capacity: the reference gathers one copy of an
expert's weights per routing unit (`w1[unit_expert]`, [K*T, d, h]); the
port computes the same function expert by expert over the units each
expert keeps, and never gathers weights per unit.

`expert_parallel_apply` is the reference's `shard_map` program on the
single-controller mesh: each position of the "expert" axis routes its own
tokens and fills an [E, cap, d] dispatch buffer on its device; the
`lax.all_to_all` becomes moving each position's slice of the buffer to
the device of the position that owns those experts, which runs them and
sends the results back the same way. Both capacity paths share
`_dispatch_plan`, so they keep and drop exactly the same units. The
expert products are `torch.matmul`, as the reference's are plain einsums
outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.initialization import default_generator
from bigdl_tpu_torch.nn.module import Module


class MoE(Module):
    """Switch/GShard-style FFN MoE: router -> top-k experts -> gated sum.

    Parameters: `router` [d, E] and the stacked expert FFNs `w1` [E, d, h],
    `b1` [E, h], `w2` [E, h, d], `b2` [E, d] (the reference's tree; drawn
    as its `init` draws them, U(-1/sqrt(d), 1/sqrt(d)) and
    U(-1/sqrt(h), 1/sqrt(h)) with zero biases, from `generator` on
    `device`). `capacity_factor` bounds the tokens per expert; a unit over
    capacity passes through with a zero expert contribution. `top_k` = 1
    (Switch) or 2 (GShard; gates renormalized over the chosen pair).

        >>> import torch
        >>> from bigdl_tpu_torch.parallel import MoE, Mesh
        >>> moe = MoE(8, 16, 4, capacity_factor=4.0, device="cpu")
        >>> x = torch.randn(16, 8, generator=torch.Generator().manual_seed(1))
        >>> y, aux = moe.apply_with_aux(x)
        >>> tuple(y.shape), tuple(aux["expert_fraction"].shape)
        ((16, 8), (4,))
        >>> y_ep = moe.expert_parallel_apply(Mesh(["cpu"] * 4, ("expert",)),
        ...                                  x)
        >>> bool(torch.allclose(y_ep, y, atol=1e-5))
        True
    """

    def __init__(self, d_model: int, d_hidden: int, n_experts: int,
                 capacity_factor: float = 1.25, top_k: int = 1, name=None,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        if top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {top_k}")
        if top_k > n_experts:
            raise ValueError(
                f"top_k={top_k} exceeds n_experts={n_experts}")
        device = resolve_device(device)
        g = default_generator(generator)
        self.d, self.h, self.E = d_model, d_hidden, n_experts
        self.capacity_factor = capacity_factor
        self.top_k = top_k
        s_in, s_h = 1.0 / math.sqrt(self.d), 1.0 / math.sqrt(self.h)

        def uniform(shape, s):
            u = torch.rand(shape, generator=g, device=g.device)
            return nn.Parameter(((u * 2 - 1) * s).to(device))

        self.router = uniform((self.d, self.E), s_in)
        self.w1 = uniform((self.E, self.d, self.h), s_in)
        self.b1 = nn.Parameter(torch.zeros(self.E, self.h, device=device))
        self.w2 = uniform((self.E, self.h, self.d), s_h)
        self.b2 = nn.Parameter(torch.zeros(self.E, self.d, device=device))

    def _gates(self, x2d, router=None):
        """Top-k routing: experts [T, k], gates [T, k] (the top-k mass,
        renormalized for k > 1), probs [T, E] for the aux loss. Equal
        probabilities (a saturated softmax's zeros) rank the lower expert
        first, as `lax.top_k` does; `torch.topk` leaves ties unordered,
        and on the card it breaks them otherwise than on the CPU."""
        router = self.router if router is None else router
        probs = torch.softmax(x2d @ router, dim=-1)
        gate_vals, experts = torch.sort(probs, dim=-1, descending=True,
                                        stable=True)
        gate_vals = gate_vals[:, :self.top_k]
        experts = experts[:, :self.top_k]
        if self.top_k > 1:
            gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
        return experts, gate_vals, probs

    @staticmethod
    def _expert_ffn(w1, b1, w2, b2, tokens):
        h = torch.relu(tokens @ w1 + b1)
        return h @ w2 + b2

    @staticmethod
    def _dispatch_plan(experts, gates, E, cap):
        """Capacity bookkeeping for one routing group, shared by the
        expert-parallel dispatch and the dense capacity oracle so both drop
        exactly the same units.

        Units are the k-major flattening of (token, choice) pairs: every
        token's first choice claims capacity before any second choice
        (GShard dispatch priority). Returns (unit_expert [K*t], unit_gate
        [K*t], pos_in_e [K*t], the 0-based slot in the expert's buffer
        from a cumulative sum, keep [K*t])."""
        unit_expert = experts.T.reshape(-1)
        unit_gate = gates.T.reshape(-1)
        onehot = F.one_hot(unit_expert, E).to(torch.int32)
        pos = torch.cumsum(onehot, dim=0) * onehot             # 1-based
        pos_in_e = pos.sum(-1) - 1
        keep = pos_in_e < cap
        return unit_expert, unit_gate, pos_in_e, keep

    def group_capacity(self, tokens_per_group: int) -> int:
        """Per-expert capacity for one routing group (Switch §2.2:
        tokens/experts * k * capacity_factor, per group)."""
        return max(1, int(math.ceil(
            tokens_per_group / self.E * self.top_k *
            self.capacity_factor)))

    # -- dense single-device reference ----------------------------------
    def forward(self, input):
        return self._dense(input)[0]

    def _dense(self, input):
        shape = input.shape
        x2d = input.reshape(-1, self.d)
        experts, gates, probs = self._gates(x2d)
        # every expert on every token, selected by routing
        h = torch.relu(torch.einsum("td,edh->teh", x2d, self.w1) + self.b1)
        y_all = torch.einsum("teh,ehd->ted", h, self.w2) + self.b2
        y = torch.zeros_like(x2d)
        for k in range(self.top_k):
            pick = experts[:, k, None, None].expand(-1, 1, self.d)
            y = y + gates[:, k, None] * y_all.gather(1, pick)[:, 0]
        return y.reshape(shape), (experts, probs)

    def apply_with_aux(self, input):
        """(output, aux): aux carries the Switch load-balancing loss
        (`aux_loss`, E * sum_e f_e * P_e, 1.0 at uniform routing) and the
        routing statistics `expert_fraction` (f_e, the fraction of tokens
        whose top-1 choice is e), `load_entropy` and `max_load`."""
        y, (experts, probs) = self._dense(input)
        f = F.one_hot(experts[:, 0], self.E).to(probs.dtype).mean(0)
        p = probs.mean(0)
        aux_loss = self.E * torch.sum(f * p)
        entropy = -torch.sum(f * torch.log(f + 1e-9))
        return y, {"aux_loss": aux_loss, "expert_fraction": f,
                   "load_entropy": entropy, "max_load": torch.max(f)}

    def dense_capacity_apply(self, x, n_groups: int = 1,
                             return_mask: bool = False):
        """Single-device reference with Switch capacity semantics: tokens
        split into `n_groups` routing groups (those of
        `expert_parallel_apply` on an n_groups-wide "expert" axis), the
        same per-group capacity, k-major priority and zero contribution
        for a dropped unit. Computed expert by expert over the units each
        expert keeps. Returns the output, or (output, keep_mask [K, T] in
        token order) with `return_mask=True`."""
        shape = x.shape
        x2d = x.reshape(-1, self.d)
        t = x2d.shape[0]
        if t % n_groups:
            raise ValueError(f"token count {t} not divisible by "
                             f"n_groups={n_groups}")
        tg = t // n_groups
        cap = self.group_capacity(tg)
        ys, masks = [], []
        for xl in x2d.split(tg):
            experts, gates, _ = self._gates(xl)
            ue, ug, _, keep = MoE._dispatch_plan(experts, gates, self.E, cap)
            unit_x = xl.repeat(self.top_k, 1)                # [K*tg, d]
            y_unit = torch.zeros_like(unit_x)
            for e in range(self.E):
                idx = torch.nonzero((ue == e) & keep)[:, 0]
                if idx.numel():
                    y_unit[idx] = self._expert_ffn(
                        self.w1[e], self.b1[e], self.w2[e], self.b2[e],
                        unit_x[idx])
            y_unit = torch.where(keep[:, None], ug[:, None] * y_unit, 0.0)
            ys.append(y_unit.reshape(self.top_k, tg, self.d).sum(0))
            masks.append(keep.reshape(self.top_k, tg))
        y = torch.cat(ys).reshape(shape)
        if return_mask:
            return y, torch.cat(masks, dim=1)
        return y

    # -- expert-parallel execution --------------------------------------
    def expert_parallel_apply(self, mesh, x, return_mask: bool = False):
        """Experts sharded over the mesh's "expert" axis (E / n experts a
        position; E divisible by the axis size), tokens split over it in
        n routing groups. Each position dispatches its kept units into
        [E, cap, d] on its device; slice j of every position's buffer
        moves to position j, which runs its experts on all n slices (the
        empty slots included, as the reference does) and sends slice i of
        the results back to position i, which gathers each kept unit's
        result, gates it and sums the k choices. Overflow drops to a zero
        contribution. Returns y on x's device, or (y, keep_mask [K, T])
        with `return_mask=True`."""
        n_experts, k_top = self.E, self.top_k
        n_dev = int(mesh.shape.get("expert", 0))
        if n_dev == 0 or n_experts % n_dev:
            raise ValueError(
                f"mesh 'expert' axis must divide n_experts={n_experts}")
        shape = x.shape
        x2d = x.reshape(-1, self.d)
        t = x2d.shape[0]
        if t % n_dev:
            raise ValueError(f"token count {t} not divisible by the "
                             f"'expert' axis size {n_dev}")
        devs = mesh.axis_devices("expert")
        cap = self.group_capacity(t // n_dev)
        e_local = n_experts // n_dev
        plans, dispatch = [], []
        for i, xl in enumerate(x2d.split(t // n_dev)):
            xl = xl.to(devs[i])
            experts, gates, _ = self._gates(xl, self.router.to(devs[i]))
            ue, ug, pos, keep = MoE._dispatch_plan(experts, gates,
                                                   n_experts, cap)
            unit_x = xl.repeat(k_top, 1)
            disp = torch.zeros(n_experts, cap, self.d, dtype=xl.dtype,
                               device=devs[i])
            disp[ue[keep], pos[keep]] = unit_x[keep]
            plans.append((ue, ug, pos.clamp(0, cap - 1), keep))
            dispatch.append(disp)
        # all_to_all: position j receives slice j of every buffer
        results = []
        for j in range(n_dev):
            lo = j * e_local
            recv = torch.stack([d[lo:lo + e_local].to(devs[j])
                                for d in dispatch])  # [n, e_local, cap, d]
            out = torch.empty_like(recv)
            for le in range(e_local):
                e = lo + le
                w = [p[e].to(devs[j]) for p in (self.w1, self.b1, self.w2,
                                                self.b2)]
                tokens = recv[:, le].reshape(-1, self.d)
                out[:, le] = self._expert_ffn(*w, tokens).reshape(
                    n_dev, cap, self.d)
            results.append(out)
        ys, masks = [], []
        for i, (ue, ug, pos, keep) in enumerate(plans):
            back = torch.cat([r[i].to(devs[i]) for r in results])
            y_unit = torch.where(keep[:, None], back[ue, pos], 0.0)
            y_unit = ug[:, None] * y_unit
            ys.append(y_unit.reshape(k_top, -1, self.d).sum(0).to(x.device))
            masks.append(keep.reshape(k_top, -1).to(x.device))
        y = torch.cat(ys).reshape(shape)
        if return_mask:
            return y, torch.cat(masks, dim=1)
        return y
