"""Mixture-of-experts FFN in PyTorch.

Port of tpullama/ops/moe.py (build_moe_ffn, src/llama-graph.cpp:880-1120)
for what a llama-family MoE such as Mixtral runs: f32 router logits ->
softmax / sigmoid / post-top-k softmax gating -> optional selection bias
-> top-k by the selection probabilities, weights gathered from the
unbiased ones -> optional renormalisation (clamped at the fp16 min normal)
-> optional w_scale -> expert SwiGLU FFN -> weighted sum over the k
experts.

Packed expert stacks go through the gathered quantized matmul
(ops/cuda/qmm_gathered.py): at decode every (token, k) slot is its own
one-row tile; from DISPATCH_MIN_SLOTS slots on, moe_dispatch sorts the
slots by expert into PREFILL_TILE_T-row tiles. Both constants are the JAX
package's defaults; its TPULLAMA_MOE_* switches are not ported. Dense
stacks gather the selected experts' weights per token.

Not ported, each refused with its name: expert parallelism (ep_axis),
group-limited routing (n_expert_groups > 1), select_logits,
select_sigmoid, weight_before_ffn, x_router, expert_div, per-expert
biases, activations other than silu (swiglu_oai, gelu, relu) and experts
without a gate.
"""

from __future__ import annotations

import torch

from .activations import swiglu
from .cuda.qmm_gathered import quantized_matmul_gathered

GATING_SOFTMAX = 1
GATING_SIGMOID = 2
GATING_SOFTMAX_WEIGHT = 3

_F16_MIN_NORMAL = 6.103515625e-5
DISPATCH_MIN_SLOTS = 64  # slots from which prefill sorts them by expert
PREFILL_TILE_T = 8  # rows per tile of the dispatched slots

def moe_dispatch(sel_flat: torch.Tensor, n_expert: int, tile_t: int):
    """Sort (token, k) slots by expert and pad each expert's group to a
    multiple of tile_t, on the device and without a host read. P is the
    static worst case S + E(tile_t - 1), rounded up to whole tiles.

    Returns (perm, tile_expert, row_of_slot, P), int32 tensors:
      perm: (P,) source slot per padded row (S for pad rows: gather from
            the slots with a zero row appended),
      tile_expert: (P // tile_t,) expert per tile,
      row_of_slot: (S,) padded row of each slot (the un-permute)."""
    S = int(sel_flat.shape[0])
    E, tt = n_expert, tile_t
    P = -(-(S + E * (tt - 1)) // tt) * tt
    dev = sel_flat.device
    sel = sel_flat.long()
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(0, sel, torch.ones_like(sel))
    padded = (counts + tt - 1) // tt * tt
    ends = torch.cumsum(padded, 0)
    group_start = ends - padded
    order = torch.argsort(sel, stable=True)  # jnp.argsort is stable too
    sorted_sel = sel[order]
    cstart = torch.cumsum(counts, 0) - counts
    rank = torch.arange(S, device=dev) - cstart[sorted_sel]
    rows_sorted = group_start[sorted_sel] + rank
    perm = torch.full((P,), S, dtype=torch.long, device=dev).scatter_(0, rows_sorted, order)
    row_of_slot = torch.empty(S, dtype=torch.long, device=dev).scatter_(0, order, rows_sorted)
    tile_expert = torch.searchsorted(ends, torch.arange(P // tt, device=dev) * tt, right=True)
    return (perm.int(), tile_expert.clamp(0, E - 1).int(), row_of_slot.int(), P)


def _ffn_packed(xf, sel, weights, gate_exps, up_exps, down_exps, metas, E):
    """Expert FFN over packed expert planes through the gathered kernels:
    the fused [gate | up] stack (per expert [gate rows_p | up rows_p], each
    half padded on its own) or split gate and up stacks, then down."""
    B, T, D = xf.shape
    K = sel.shape[-1]
    S = B * T * K
    sel_flat = sel.reshape(S)
    x_slots = xf[:, :, None, :].expand(B, T, K, D).reshape(S, D)
    row_of_slot = None
    if S >= DISPATCH_MIN_SLOTS:
        tile_t = PREFILL_TILE_T
        perm, tile_expert, row_of_slot, _ = moe_dispatch(sel_flat, E, tile_t)
        x_rows = torch.cat([x_slots, x_slots.new_zeros((1, D))])[perm]
    else:
        tile_t = 1
        tile_expert = sel_flat
        x_rows = x_slots

    def gmm(x_in, w, name):
        m = metas[name]
        # 2-D planes (E * rows, kcols) are one layer's experts flattened
        fields = {k: v if v.dim() == 3 else v.reshape(E, v.shape[0] // E, v.shape[1])
                  for k, v in w.items()}
        return quantized_matmul_gathered(x_in, fields, tile_expert, m.ggml_type, m.group,
                                         m.n_out // E, m.n_in, tile_t=tile_t,
                                         planes_t=m.planes_t)

    if "gateup" in metas:
        gu = gmm(x_rows, up_exps, "gateup")
        F = metas["down"].n_in  # the true per-expert F
        half = metas["gateup"].n_out // E // 2  # the padded half's rows
        gate, up = gu[:, :F], gu[:, half:half + F]
    else:
        up = gmm(x_rows, up_exps, "up")
        gate = gmm(x_rows, gate_exps, "gate")
    down = gmm(swiglu(gate, up), down_exps, "down")
    if row_of_slot is not None:
        down = down[row_of_slot]
    down = down.reshape(B, T, K, D) * weights.reshape(B, T, K, 1).float()
    return down.sum(dim=2)


def route(xf, gate_inp, n_expert_used: int, gating: int = GATING_SOFTMAX,
          norm_w: bool = True, w_scale: float = 0.0, exp_probs_b=None, gate_inp_b=None):
    """The router: f32 tokens (B, T, D) -> the selected experts (B, T, k)
    and their f32 weights (B, T, k)."""
    # f32 logits, summed in f64: cuBLAS picks its f32 summation order by the
    # product's shape, and a token's routing must not depend on how many
    # rows share its step (the server batches requests together)
    logits = (xf.double() @ gate_inp.double().T).float()
    if gate_inp_b is not None:
        logits = logits + gate_inp_b.float()
    if gating == GATING_SOFTMAX:
        probs = torch.softmax(logits, dim=-1)
    elif gating == GATING_SIGMOID:
        probs = torch.sigmoid(logits)
    elif gating == GATING_SOFTMAX_WEIGHT:  # softmax after the top-k
        probs = logits
    else:
        raise ValueError(f"moe_ffn: gating {gating}")
    selection = probs if exp_probs_b is None else probs + exp_probs_b.float()
    sel = torch.topk(selection, n_expert_used, dim=-1).indices
    weights = torch.gather(probs, -1, sel)
    if gating == GATING_SOFTMAX_WEIGHT:
        weights = torch.softmax(weights, dim=-1)
    if norm_w:
        weights = weights / weights.sum(dim=-1, keepdim=True).clamp(min=_F16_MIN_NORMAL)
    if w_scale:
        weights = weights * w_scale
    return sel, weights


def moe_ffn(x, gate_inp, gate_exps, up_exps, down_exps, *, n_expert_used: int,
            gating: int = GATING_SOFTMAX, norm_w: bool = True, w_scale: float = 0.0,
            act: str = "silu", exp_probs_b=None, gate_inp_b=None, up_exps_b=None,
            gate_exps_b=None, down_exps_b=None, weight_before_ffn: bool = False,
            select_logits: bool = False, x_router=None, select_sigmoid: bool = False,
            expert_div: int = 0, n_expert_groups: int = 0, ep_axis=None,
            quant_meta_exps: dict | None = None):
    """x: (B, T, D); gate_inp: (E, D) router; gate/up_exps: (E, F, D) and
    down_exps (E, D, F) dense, or dicts of packed planes with
    quant_meta_exps {"gate", "up", "down"} or {"gateup", "down"} (then
    gate_exps is None and up_exps the fused stack). Returns (B, T, D) in
    x's dtype."""
    refused = {"up_exps_b": up_exps_b is not None, "gate_exps_b": gate_exps_b is not None,
               "down_exps_b": down_exps_b is not None, "weight_before_ffn": weight_before_ffn,
               "select_logits": select_logits, "x_router": x_router is not None,
               "select_sigmoid": select_sigmoid, "expert_div": bool(expert_div),
               "n_expert_groups": n_expert_groups > 1, "ep_axis": ep_axis is not None,
               f"act={act!r}": act != "silu"}
    for name, on in refused.items():
        if on:
            raise NotImplementedError(f"moe_ffn: {name} is not ported yet")
    fused = quant_meta_exps is not None and "gateup" in quant_meta_exps
    if gate_exps is None and not fused:
        raise NotImplementedError("moe_ffn: experts without a gate are not ported yet")

    B, T, D = x.shape
    E = gate_inp.shape[0]
    xf = x.float()
    sel, weights = route(xf, gate_inp, n_expert_used, gating, norm_w, w_scale,
                         exp_probs_b, gate_inp_b)
    if quant_meta_exps is not None and isinstance(up_exps, dict):
        return _ffn_packed(xf, sel, weights, gate_exps, up_exps, down_exps,
                           quant_meta_exps, E).to(x.dtype)

    # dense experts: gather the selected experts' weights per (token, k)
    xk = xf[:, :, None, :].expand(B, T, n_expert_used, D)
    up = torch.einsum("btkd,btkfd->btkf", xk, up_exps[sel].float())
    gate = torch.einsum("btkd,btkfd->btkf", xk, gate_exps[sel].float())
    out = torch.einsum("btkf,btkdf->btkd", swiglu(gate, up), down_exps[sel].float())
    return (out * weights[..., None]).sum(dim=2).to(x.dtype)
