"""The fused post-attention decode step: the CUDA kernel's wrapper, its
plain PyTorch version, and the eligibility rule of the JAX package.

Port of tpullama/ops/pallas/fused_layer.py. For one token of one
sequence (T == 1, B == 1) after attention:

    r1  = x_res + attn_output(att)
    h   = rms_norm(r1) * norm_w
    act = silu(gate) * up,  [gate | up] = ffn_up(h)

returning (act, r1); the caller finishes with y = r1 + ffn_down(act). The
attn_output and fused [gate|up] weights are {q4, scale, minv} planes in
fourblock stored order (ops/qweights.to_fourblock). On CUDA tensors the
wrapper launches csrc/fused_layer.cu (one cooperative launch whose two
matvecs run the decode body of csrc/qmm_gemv.cuh) or raises; on CPU
tensors it computes the plain version.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ...gguf.constants import GGMLType
from .qmm import dequant_stored, permute_x

# launches since the last reset (chip_smoke.py reads it)
LAUNCHES = {"fused_postattn": 0}
_FIELDS = {"q4", "scale", "minv"}


def resolve_fused_layer(value: bool | None) -> bool:
    """Whether the fused post-attention path is on: `value`, else the
    TPULLAMA_FUSED_LAYER environment variable as the JAX package reads it
    (any value but "0" or empty turns it on)."""
    if value is not None:
        return bool(value)
    return os.environ.get("TPULLAMA_FUSED_LAYER", "0") not in ("0", "")


def fused_ok(hp, w, lmeta) -> bool:
    """Static eligibility for the fused post-attention path, the JAX
    package's fused_ok (fused_layer.py:255) condition for condition:
    attn_output and the fused [gate|up] ffn_up packed as {q4, scale, minv}
    planes, unpadded, in fourblock order, one group size, and n_embd a
    multiple of 128 * g. The reference tests `isinstance(v, tuple)`
    because its scan path hands each packed stack over as (fields, layer
    index); a layer's planes here are a dict."""
    names = ("attn_output", "ffn_up")
    for n in names:
        v = w.get(n)
        if not isinstance(v, dict):
            return False
        if set(v) != _FIELDS:
            return False
        m = lmeta.get(n)
        if m is None or m.group <= 0:
            return False
        if v["q4"].shape[-2] != m.n_out or m.n_out % 128 or m.n_in % 128:
            return False
        if getattr(m, "order", "stripe") != "fourblock":
            return False
    g = lmeta["attn_output"].group
    if any(lmeta[n].group != g for n in names):
        return False
    return lmeta["ffn_up"].n_in % (128 * g) == 0


def fused_postattn_plain(att, x_res, o_fields, norm_w, gu_fields, *, group: int,
                         eps: float):
    """Plain version in f32: exact dequantization of both matrices (the
    {q4, scale, minv} set decodes alike for Q4_0/Q4_1/Q4_K) and f32
    products against the fourblock-permuted activations. Returns
    (act (1, Fd), r1 (1, E)) f32."""
    E, Dq = x_res.shape[-1], att.shape[-1]
    wo = dequant_stored(o_fields, GGMLType.Q4_K, group)
    wgu = dequant_stored(gu_fields, GGMLType.Q4_K, group)
    Fd = wgu.shape[0] // 2
    r1 = x_res.float().reshape(1, E) + permute_x(att.float().reshape(1, Dq), group,
                                                 "fourblock") @ wo.T
    h = r1 * (1.0 / torch.sqrt((r1 * r1).sum() / E + eps)) * norm_w.float().reshape(1, E)
    g = permute_x(h, group, "fourblock") @ wgu.T
    return F.silu(g[:, :Fd]) * g[:, Fd:], r1


def check_inputs(att, x_res, o_fields, norm_w, gu_fields, *, group: int):
    """The kernel's checks of shapes, field sets and dtypes, on tensors of
    any one device (the wrapper runs them before each launch). Returns (E,
    Dq, 2 Fd, x dtype, scale dtype)."""
    E, Dq = x_res.shape[-1], att.shape[-1]
    F2 = gu_fields["q4"].shape[0]
    if att.numel() != Dq or x_res.numel() != E or norm_w.numel() != E or F2 % 2:
        raise ValueError(f"fused_postattn: att {tuple(att.shape)}, x_res {tuple(x_res.shape)}, "
                         f"norm_w {tuple(norm_w.shape)}, [gate|up] rows {F2}")
    if group != 32:
        raise ValueError(f"fused_postattn kernel: group {group} (covers 32)")
    # the fourblock order's rows of 128 (fused_ok admits Dq % 128, E % 4096);
    # the kernel stages x in slices of 8192 values, so any width fits
    if Dq % 128 or E % 128:
        raise ValueError(f"fused_postattn kernel: Dq={Dq}, E={E} must be multiples of 128")
    sdt = o_fields["scale"].dtype
    for fields, n, k in ((o_fields, E, Dq), (gu_fields, F2, E)):
        if set(fields) != _FIELDS:
            raise NotImplementedError(f"fused_postattn kernel: fields {sorted(fields)}")
        for name, a in fields.items():
            want = (n, k // 2) if name == "q4" else (n, k // group)
            if (a.device != att.device or tuple(a.shape) != want or not a.is_contiguous()
                    or a.dtype != (torch.uint8 if name == "q4" else sdt)):
                raise ValueError(f"fused_postattn: field {name} {tuple(a.shape)} {a.dtype} on "
                                 f"{a.device}; want {want} on {att.device}")
    if sdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_postattn: scale dtype {sdt} (f32 or bf16)")
    vecs = [att, x_res, norm_w]
    xdt = att.dtype if all(v.dtype == att.dtype for v in vecs) else torch.float32
    if xdt not in (torch.float32, torch.bfloat16):
        xdt = torch.float32
    return E, Dq, F2, xdt, sdt


def fused_postattn(att, x_res, o_fields, norm_w, gu_fields, *, group: int, eps: float):
    """att: (1, Dq) attention output (before the o-projection); x_res:
    (1, E) residual input; o_fields: attn_output planes (E rows);
    gu_fields: [gate|up] planes (2 Fd rows), both {q4, scale, minv} in
    fourblock order; norm_w: (E,) ffn_norm weight. Returns (act (1, Fd),
    r1 (1, E)) f32, act in natural element order."""
    if att.device.type == "cpu":
        return fused_postattn_plain(att, x_res, o_fields, norm_w, gu_fields, group=group,
                                    eps=eps)
    if att.device.type != "cuda":
        raise RuntimeError(f"fused_postattn: unsupported device {att.device}")
    from .build import check, library, ptr, stream

    E, Dq, F2, xdt, sdt = check_inputs(att, x_res, o_fields, norm_w, gu_fields, group=group)
    # the body reads att and norm_w by 16-byte loads
    att, x_res, norm_w = (v.to(device=att.device, dtype=xdt).contiguous()
                          for v in (att, x_res, norm_w))
    att, norm_w = (v if v.data_ptr() % 16 == 0 else v.clone() for v in (att, norm_w))
    act = torch.empty((1, F2 // 2), dtype=torch.float32, device=att.device)
    r1 = torch.empty((1, E), dtype=torch.float32, device=att.device)
    check(library().tpl_fused_postattn(
        int(xdt == torch.bfloat16), int(sdt == torch.bfloat16), ptr(att), ptr(x_res),
        ptr(norm_w), ptr(o_fields["q4"]), ptr(o_fields["scale"]), ptr(o_fields["minv"]),
        ptr(gu_fields["q4"]), ptr(gu_fields["scale"]), ptr(gu_fields["minv"]), ptr(act),
        ptr(r1), E, Dq, F2 // 2, float(eps), stream()), "fused_postattn")
    LAUNCHES["fused_postattn"] += 1
    return act, r1
