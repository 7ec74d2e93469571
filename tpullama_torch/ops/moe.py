"""Mixture-of-experts FFN in PyTorch.

Port of tpullama/ops/moe.py (build_moe_ffn, src/llama-graph.cpp:880-1120)
for what the MoE archs of the llama forward run (Mixtral-style llama,
qwen2moe, qwen3moe, granitemoe, glm4moe, dots1, ernie4_5-moe, bailingmoe2,
gpt-oss, llama4, hunyuan-moe; their shared experts run in
models/llama.py): f32 router logits (plus the router bias) -> softmax /
sigmoid / post-top-k softmax gating -> optional selection bias -> optional
group-limited routing (the top n_group_used of n_expert_groups groups,
each scored by the sum of its top 2, the rest masked to -inf) -> top-k by
the selection probabilities (llama4's select_logits: by the raw logits),
weights gathered from the unbiased ones -> optional renormalisation
(clamped at the fp16 min normal) -> optional w_scale -> expert FFN (SwiGLU,
or gpt-oss's swiglu_oai, with the per-expert gate/up/down biases where
given) -> weighted sum over the k experts. With weight_before_ffn
(llama4) each (token, k) slot's input is scaled by its weight instead and
the expert outputs are summed unweighted, on all three routes.

Packed expert stacks go through the gathered quantized matmul
(ops/cuda/qmm_gathered.py): at decode every (token, k) slot is its own
one-row tile; from DISPATCH_MIN_SLOTS slots on, moe_dispatch sorts the
slots by expert into PREFILL_TILE_T-row tiles. Both constants are the JAX
package's defaults; its TPULLAMA_MOE_* switches are not ported.

Dense stacks compute the JAX package's dense branch (f32 products per
(token, k) pair, SwiGLU, times the pair's weight, summed over k;
tpullama/ops/moe.py:323-388) without its gathered (B, T, k, F, D) weight
tensor, which at GLM-4.5-Air's widths would take ~189 GB for a 4 x 256
chunk: a one-token step (T == 1) gathers each of its B * k pairs'
experts (fixed shapes and no host read, so a CUDA graph captures it);
T > 1 sorts the pairs by expert and multiplies each selected expert's
rows at once (one host read of the counts; prefill runs eagerly).

Not ported, each refused with its name and needed by MoE archs not
loaded yet (ROADMAP.md Queue 1 item 5): expert parallelism (ep_axis),
select_sigmoid, x_router, expert_div, activations other than silu and
swiglu_oai (gelu, relu) and experts without a gate.
"""

from __future__ import annotations

import torch

from .activations import swiglu, swiglu_oai
from .cuda.qmm_gathered import quantized_matmul_gathered

GATING_SOFTMAX = 1
GATING_SIGMOID = 2
GATING_SOFTMAX_WEIGHT = 3

_F16_MIN_NORMAL = 6.103515625e-5
DISPATCH_MIN_SLOTS = 64  # slots from which prefill sorts them by expert
PREFILL_TILE_T = 8  # rows per tile of the dispatched slots
ACTS = {"silu": swiglu, "swiglu_oai": swiglu_oai}  # the expert activations ported


def _add(t, bias, rows):
    """t plus each row's expert bias (bias (E, n)[rows]), or t without one."""
    return t if bias is None else t + bias[rows].float()


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


def _slots(xf, weights, weight_before_ffn: bool):
    """Each (token, k) slot's f32 input, (B, T, K, D): the token's row, or
    with weight_before_ffn that row times the slot's weight."""
    B, T, D = xf.shape
    x = xf[:, :, None, :]
    if weight_before_ffn:
        return x * weights[..., None].float()
    return x.expand(B, T, weights.shape[-1], D)


def _combine(out, weights, weight_before_ffn: bool):
    """The slots' outputs (B, T, K, D) summed over k, each times its weight
    unless the weights scaled the inputs."""
    if not weight_before_ffn:
        out = out * weights[..., None].float()
    return out.sum(dim=2)


def _ffn_packed(xf, sel, weights, gate_exps, up_exps, down_exps, metas, E, act="silu",
                biases=(None, None, None), weight_before_ffn: bool = False):
    """Expert FFN over packed expert planes through the gathered kernels:
    the fused [gate | up] stack (per expert [gate rows_p | up rows_p], each
    half padded on its own) or split gate and up stacks, then down. The
    per-expert (gate, up, down) `biases` are added to the kernels' outputs
    by each row's expert, as the JAX package's packed path adds them."""
    B, T, D = xf.shape
    K = sel.shape[-1]
    S = B * T * K
    sel_flat = sel.reshape(S)
    x_slots = _slots(xf, weights, weight_before_ffn).reshape(S, D)
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
    gate_b, up_b, down_b = biases
    row_expert = torch.repeat_interleave(tile_expert.long(), tile_t)
    h = ACTS[act](_add(gate, gate_b, row_expert), _add(up, up_b, row_expert))
    down = _add(gmm(h, down_exps, "down"), down_b, row_expert)
    if row_of_slot is not None:
        down = down[row_of_slot]
    return _combine(down.reshape(B, T, K, D), weights, weight_before_ffn)


def _pair_products(x_pairs, sel_flat, gate_exps, up_exps, down_exps, act="silu",
                   biases=(None, None, None)):
    """The expert FFN of each (token, k) pair by its own expert's weights
    and (gate, up, down) `biases`, gathered one expert per pair: x_pairs
    (N, D) f32, sel_flat (N,) -> (N, D) f32."""
    x = x_pairs[:, :, None]
    gate_b, up_b, down_b = biases
    gate = _add(torch.bmm(gate_exps[sel_flat].float(), x)[..., 0], gate_b, sel_flat)
    up = _add(torch.bmm(up_exps[sel_flat].float(), x)[..., 0], up_b, sel_flat)
    h = ACTS[act](gate, up)
    return _add(torch.bmm(down_exps[sel_flat].float(), h[:, :, None])[..., 0], down_b, sel_flat)


def _sorted_products(x_pairs, sel_flat, gate_exps, up_exps, down_exps, act="silu",
                     biases=(None, None, None)):
    """The same as _pair_products with the pairs sorted by expert: each
    selected expert's weights turn f32 once and multiply all its rows in
    one product, and the rows go back to pair order."""
    E = gate_exps.shape[0]
    gate_b, up_b, down_b = biases
    order = torch.argsort(sel_flat, stable=True)
    counts = torch.bincount(sel_flat, minlength=E).tolist()
    xs = x_pairs[order]
    out = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(counts):
        if not n:
            continue
        rows = xs[start:start + n]
        gate = _add(rows @ gate_exps[e].float().T, gate_b, e)
        up = _add(rows @ up_exps[e].float().T, up_b, e)
        out[start:start + n] = _add(ACTS[act](gate, up) @ down_exps[e].float().T, down_b, e)
        start += n
    return torch.empty_like(out).index_copy_(0, order, out)


def _ffn_dense(xf, sel, weights, gate_exps, up_exps, down_exps, act="silu",
               biases=(None, None, None), weight_before_ffn: bool = False):
    """Expert FFN over dense (E, F, D) / (E, D, F) stacks: per pair at
    T == 1 (_pair_products), sorted by expert at T > 1
    (_sorted_products)."""
    B, T, D = xf.shape
    K = sel.shape[-1]
    x_pairs = _slots(xf, weights, weight_before_ffn).reshape(B * T * K, D)
    sel_flat = sel.reshape(-1)
    products = _pair_products if T == 1 else _sorted_products
    out = products(x_pairs, sel_flat, gate_exps, up_exps, down_exps, act, biases)
    return _combine(out.reshape(B, T, K, D), weights, weight_before_ffn)


def route(xf, gate_inp, n_expert_used: int, gating: int = GATING_SOFTMAX,
          norm_w: bool = True, w_scale: float = 0.0, exp_probs_b=None, gate_inp_b=None,
          n_expert_groups: int = 0, n_group_used: int = 0, select_logits: bool = False):
    """The router: f32 tokens (B, T, D) -> the selected experts (B, T, k)
    and their f32 weights (B, T, k). With n_expert_groups > 1 the top-k
    picks from the n_group_used groups whose top 2 selection scores sum
    highest (the JAX package's group-limited routing); with select_logits
    it ranks the raw logits (llama4, llama-graph.cpp:947-949), the weights
    still the gated probabilities."""
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
    if select_logits:
        selection = logits
    if n_expert_groups > 1:
        E = selection.shape[-1]
        sg = selection.reshape(*selection.shape[:-1], n_expert_groups, E // n_expert_groups)
        group_scores = torch.topk(sg, 2, dim=-1).values.sum(dim=-1)
        gsel = torch.topk(group_scores, n_group_used, dim=-1).indices
        keep = torch.zeros_like(group_scores, dtype=torch.bool).scatter_(-1, gsel, True)
        selection = torch.where(keep[..., None], sg, float("-inf")).reshape(selection.shape)
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
            expert_div: int = 0, n_expert_groups: int = 0, n_group_used: int = 0,
            ep_axis=None, quant_meta_exps: dict | None = None):
    """x: (B, T, D); gate_inp: (E, D) router; gate/up_exps: (E, F, D) and
    down_exps (E, D, F) dense, or dicts of packed planes with
    quant_meta_exps {"gate", "up", "down"} or {"gateup", "down"} (then
    gate_exps is None and up_exps the fused stack); gate_exps_b, up_exps_b
    (E, F) and down_exps_b (E, D): per-expert biases. Returns (B, T, D) in
    x's dtype."""
    refused = {"x_router": x_router is not None,
               "select_sigmoid": select_sigmoid, "expert_div": bool(expert_div),
               "ep_axis": ep_axis is not None, f"act={act!r}": act not in ACTS}
    for name, on in refused.items():
        if on:
            raise NotImplementedError(f"moe_ffn: {name} is not ported yet")
    fused = quant_meta_exps is not None and "gateup" in quant_meta_exps
    if gate_exps is None and not fused:
        raise NotImplementedError("moe_ffn: experts without a gate are not ported yet")

    xf = x.float()
    sel, weights = route(xf, gate_inp, n_expert_used, gating, norm_w, w_scale,
                         exp_probs_b, gate_inp_b, n_expert_groups, n_group_used, select_logits)
    biases = (gate_exps_b, up_exps_b, down_exps_b)
    if quant_meta_exps is not None and isinstance(up_exps, dict):
        return _ffn_packed(xf, sel, weights, gate_exps, up_exps, down_exps,
                           quant_meta_exps, gate_inp.shape[0], act, biases,
                           weight_before_ffn).to(x.dtype)
    return _ffn_dense(xf, sel, weights, gate_exps, up_exps, down_exps, act,
                      biases, weight_before_ffn).to(x.dtype)
