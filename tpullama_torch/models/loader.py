"""Model loader: GGUF -> PyTorch parameters on a device.

Port of tpullama/models/loader.py for the llama family (llama, mistral,
qwen2, chatglm, and Mixtral-style MoE llama). Per-layer tensors of equal shape are
stacked along a leading layer axis, as in the JAX package, so the two
packages hold the same arrays under the same names; the forward pass
walks per-layer views of the stacks.

Two weight modes:
  - dense (default): blocks decoded to `dtype` at load.
  - packed: supported quantized 2-D weights repacked into the planar
    layout of ops/qweights.py (uint8 planes + scale/min planes), byte for
    byte the JAX package's planes, for the fused dequant-matmul kernel.
    Only `output` among the top-level tensors is packed; the token table
    stays dense, as in the JAX package. Expert tensors pack as flat
    (n_layer * n_expert, rows_p, kcols) stacks, rows zero-padded to 128,
    transposed by the JAX loader's planes_t rule, with gate and up fused
    into one [gate | up] stack (ffn_gateup_exps). With `fused_layer` on,
    the {q4, scale, minv} attn_output, ffn_up and ffn_down stacks are
    re-encoded to the fourblock stored order the fused post-attention
    kernel reads (ops/qweights.to_fourblock), as the JAX loader does.

`params_from_numpy` carries a JAX-loaded model's parameters across (as
numpy arrays), so both packages can be held against each other on the
same bytes.
"""

from __future__ import annotations

import concurrent.futures as _fut
import dataclasses
import os
import re
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..gguf import GGMLType, GGUFReader
from ..gguf.quants import dequantize
from ..ops.cuda.fused_layer import resolve_fused_layer
from ..ops.cuda.qmm_gathered import PLANES_T_FIELDS
from ..ops.qweights import PACKED_TYPES, repack, to_fourblock, transpose_planes
from .hparams import LLAMA_FAMILY, HParams

# per-layer tensor suffixes of the llama family -> param names
_LAYER_TENSORS = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "attn_q",
    "attn_k.weight": "attn_k",
    "attn_v.weight": "attn_v",
    "attn_output.weight": "attn_output",
    "attn_qkv.weight": "attn_qkv",
    "attn_qkv.bias": "attn_qkv_bias",
    "attn_q.bias": "attn_q_bias",
    "attn_k.bias": "attn_k_bias",
    "attn_v.bias": "attn_v_bias",
    "ffn_norm.weight": "ffn_norm",
    "ffn_gate.weight": "ffn_gate",
    "ffn_up.weight": "ffn_up",
    "ffn_down.weight": "ffn_down",
    "ffn_gate_inp.weight": "ffn_gate_inp",
    "ffn_gate_exps.weight": "ffn_gate_exps",
    "ffn_up_exps.weight": "ffn_up_exps",
    "ffn_down_exps.weight": "ffn_down_exps",
}
_EXPERT_TRIO = ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")
# the layer matrices the fused post-attention path reads in fourblock order
_FOURBLOCK_KEYS = ("attn_output", "ffn_up", "ffn_down")

_TOP_TENSORS = {
    "token_embd.weight": "tok_embd",
    "output_norm.weight": "output_norm",
    "output.weight": "output",
    "rope_freqs.weight": "rope_freqs",
}

# rows dequantized per host batch when a large dense tensor is decoded
_DENSE_ROWS = 8192


@dataclass(frozen=True)
class QuantMeta:
    """Static metadata for one packed weight."""

    ggml_type: GGMLType
    group: int
    n_out: int
    n_in: int
    # transposed planes (..., kcols, rows) of an expert stack, for the
    # transposed gathered kernel (ops/cuda/qmm_gathered.py)
    planes_t: bool = False
    # stored element order of the planes: "stripe" or "fourblock"
    # (ops/qweights.py)
    order: str = "stripe"


@dataclass
class LoadedModel:
    hparams: HParams
    params: dict  # tensors (dense) / dicts of planes (packed) on `device`
    reader: GGUFReader | None
    vocab: object = None
    quant_meta: dict | None = None  # mirrors packed params; None = dense
    device: torch.device = torch.device("cpu")

    @property
    def arch(self) -> str:
        return self.hparams.arch

    def nbytes(self) -> int:
        """Bytes the parameters occupy on the device."""
        def walk(t):
            if isinstance(t, dict):
                return sum(walk(v) for v in t.values())
            return t.numel() * t.element_size()

        return walk(self.params)


def check_supported(hp: HParams) -> None:
    """Raise for anything outside the slices ported: the llama family
    (chatglm included), and MoE on the llama arch (Mixtral) without
    group-limited routing."""
    if hp.arch not in LLAMA_FAMILY:
        raise NotImplementedError(f"tpullama_torch: arch {hp.arch!r} is not ported yet")
    if hp.n_swa:
        raise NotImplementedError(
            f"tpullama_torch: {hp.arch!r} with sliding-window attention is not ported yet")
    if hp.n_expert and hp.arch != "llama":
        raise NotImplementedError(f"tpullama_torch: {hp.arch!r} with MoE is not ported yet")
    if hp.n_expert_groups > 1:
        raise NotImplementedError(
            "tpullama_torch: MoE with group-limited routing is not ported yet")


def _expert_planes(fields: dict, n_expert: int) -> tuple[dict, bool]:
    """One layer's repacked expert tensor, planes (n_expert * rows, kcols)
    -> (n_expert, rows_p, kcols) with rows zero-padded to a multiple of
    128; then transposed to (n_expert, kcols, rows_p) by the JAX loader's
    planes_t rule (tpullama/models/loader.py:598-626): some plane's width
    is not a multiple of 128, the field set has one stripe width, and every
    quant plane's width is a multiple of 32. Returns (planes, planes_t)."""
    out = {}
    for k, v in fields.items():
        rows = v.shape[0] // n_expert
        rows_p = -(-rows // 128) * 128
        a = v.reshape(n_expert, rows, v.shape[-1])
        out[k] = np.pad(a, ((0, 0), (0, rows_p - rows), (0, 0))) if rows_p != rows else a
    planes_t = (any(v.shape[-1] % 128 for v in out.values())
                and set(out) <= PLANES_T_FIELDS
                and all(v.shape[-1] % (32 if v.dtype.itemsize == 1 else 16) == 0
                        for k, v in out.items() if k not in ("scale", "minv")))
    return (transpose_planes(out) if planes_t else out), planes_t


def _torch_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        return getattr(torch, d)
    return torch.from_numpy(np.zeros(0, np.dtype(d))).dtype


def load_model(source, dtype=torch.float32, device=None, packed: bool = False,
               packed_scale_dtype=torch.bfloat16, load_vocab: bool = True,
               fused_layer: bool | None = None) -> LoadedModel:
    """Load a llama-family GGUF (path or bytes) onto `device` (default
    cuda; raises without a GPU unless device="cpu" is passed).

    `packed=True` keeps supported quantized 2-D weights in planar packed
    form for the fused dequant-matmul kernel; their scale/min planes are
    stored in `packed_scale_dtype` (bf16 by default, as in the JAX
    package; pass torch.float32 for bit-exact planes). `fused_layer`
    (default: the TPULLAMA_FUSED_LAYER environment variable, as the JAX
    loader reads it) stores the packed {q4, scale, minv} attn_output,
    ffn_up and ffn_down in fourblock order for the fused post-attention
    kernel."""
    device = resolve_device(device)
    fused_layer = resolve_fused_layer(fused_layer)
    dtype = _torch_dtype(dtype)
    sdt = _torch_dtype(packed_scale_dtype) if packed_scale_dtype is not None else torch.float32
    reader = GGUFReader(source)
    hp = HParams.from_gguf(reader)
    check_supported(hp)

    layer_names: dict[int, dict[str, str]] = {}
    top: dict[str, str] = {}
    pat = re.compile(r"^blk\.(\d+)\.(.+)$")
    for name in reader.tensors:
        m = pat.match(name)
        if m:
            pname = _LAYER_TENSORS.get(m.group(2))
            if pname is None:
                raise NotImplementedError(f"tpullama_torch: tensor {name!r} is not ported yet")
            layer_names.setdefault(int(m.group(1)), {})[pname] = name
        elif name in _TOP_TENSORS:
            top[_TOP_TENSORS[name]] = name
    n_layer = hp.n_layer or (max(layer_names) + 1 if layer_names else 0)

    def packable(tname: str, allow_3d: bool = False) -> bool:
        info = reader.tensors[tname]
        return (packed and (len(info.shape) == 2 or (allow_3d and len(info.shape) == 3))
                and info.ggml_type in PACKED_TYPES and info.shape[-1] % 256 == 0)

    def fetch_dense(tname: str, out: torch.Tensor) -> None:
        """Dequantize a tensor into `out` (any device), in row batches."""
        info = reader.tensors[tname]
        raw = reader.tensor_raw(tname)
        if len(info.shape) < 2:
            out.copy_(torch.from_numpy(dequantize(raw, info.ggml_type, info.shape)))
            return
        rows = int(np.prod(info.shape[:-1]))
        per_row = raw.size // rows
        flat = out.view(rows, info.shape[-1])
        for r0 in range(0, rows, _DENSE_ROWS):
            r1 = min(rows, r0 + _DENSE_ROWS)
            part = dequantize(raw[r0 * per_row:r1 * per_row], info.ggml_type,
                              (r1 - r0, info.shape[-1]))
            flat[r0:r1].copy_(torch.from_numpy(part))

    def fetch_packed(tname: str, key: str | None = None) -> tuple[dict, QuantMeta]:
        """A tensor's planes and meta. Expert tensors come back as
        (n_expert, ...) planes; every other one as (1, n_out, kcols), in
        fourblock order where the fused layer reads layer matrix `key`
        (the JAX loader's condition, loader.py:629-642)."""
        info = reader.tensors[tname]
        n_rows = int(np.prod(info.shape[:-1]))
        pq = repack(reader.tensor_raw(tname), info.ggml_type, (n_rows, info.shape[-1]))
        if len(info.shape) == 3:
            fields, planes_t = _expert_planes(pq.fields, info.shape[0])
            return fields, QuantMeta(pq.ggml_type, pq.group, *pq.shape, planes_t=planes_t)
        if (fused_layer and key in _FOURBLOCK_KEYS
                and set(pq.fields) == {"q4", "scale", "minv"}
                and pq.shape[1] % 128 == 0 and 128 % pq.group == 0):
            pq = to_fourblock(pq)
        return ({k: v[None] for k, v in pq.fields.items()},
                QuantMeta(pq.ggml_type, pq.group, *pq.shape, order=pq.order))

    def to_device(a: np.ndarray, scale_plane: bool) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if scale_plane:
            t = t.to(sdt)
        return t.to(device)

    params: dict = {}
    quant_meta: dict = {}
    for pname, tname in top.items():
        info = reader.tensors[tname]
        if pname == "output" and packable(tname):
            fields, quant_meta[pname] = fetch_packed(tname)
            params[pname] = {k: to_device(v[0], k in ("scale", "minv"))
                             for k, v in fields.items()}
        else:
            t = torch.empty(info.shape, dtype=dtype if pname != "rope_freqs" else torch.float32,
                            device=device)
            fetch_dense(tname, t)
            params[pname] = t

    if n_layer:
        keys = sorted(layer_names.get(0, {}))
        stacked: dict = {}
        layer_meta: dict = {}
        jobs = []

        def uniform(key: str, allow_3d: bool = False) -> bool:
            # a packed stack needs one type across layers (mixed per-layer
            # types fall back to dense for that tensor, as in the JAX loader)
            tnames = [layer_names[il][key] for il in range(n_layer)]
            return (len({reader.tensors[t].ggml_type for t in tnames}) == 1
                    and packable(tnames[0], allow_3d))

        # the expert trio packs only as a group (the JAX loader's
        # _trio_packable): every member present must be uniform and packable
        exps_ok = "ffn_up_exps" in keys and all(
            uniform(k, allow_3d=True) for k in _EXPERT_TRIO if k in keys)
        for key in keys:
            tnames = [layer_names[il][key] for il in range(n_layer)]
            if exps_ok if key in _EXPERT_TRIO else uniform(key):
                jobs.append((key, tnames))
            else:
                info = reader.tensors[tnames[0]]
                t = torch.empty((n_layer, *info.shape), dtype=dtype, device=device)
                for il, tn in enumerate(tnames):
                    fetch_dense(tn, t[il])
                stacked[key] = t
        # repack on host threads (numpy releases the GIL in the bulk ops),
        # copy each layer's planes into the device stack as it completes
        work = [(key, il, tn) for key, tnames in jobs for il, tn in enumerate(tnames)]
        n_workers = max(1, min(8, os.cpu_count() or 1))
        with _fut.ThreadPoolExecutor(n_workers) as pool:
            futs = {pool.submit(fetch_packed, tn, key): (key, il) for key, il, tn in work}
            for f in _fut.as_completed(futs):
                key, il = futs[f]
                fields, layer_meta[key] = f.result()
                if key not in stacked:
                    # (n_layer * c, ...): each layer's c = 1 matrix or
                    # n_expert experts, layer after layer
                    stacked[key] = {
                        k: torch.empty((n_layer * v.shape[0], *v.shape[1:]),
                                       dtype=(sdt if k in ("scale", "minv")
                                              else torch.from_numpy(v[:0]).dtype),
                                       device=device)
                        for k, v in fields.items()
                    }
                for k, v in fields.items():
                    c = v.shape[0]
                    stacked[key][k][il * c:(il + 1) * c].copy_(
                        to_device(v, k in ("scale", "minv")))
        mg, mu = layer_meta.get("ffn_gate_exps"), layer_meta.get("ffn_up_exps")
        if mg and mu and ((mg.ggml_type, mg.group, mg.n_in, mg.planes_t)
                          == (mu.ggml_type, mu.group, mu.n_in, mu.planes_t)):
            # one [gate | up] stack: per expert [gate rows_p | up rows_p],
            # on the rows axis of either layout (the JAX loader's fusion)
            axis = -1 if mg.planes_t else -2
            g_f, u_f = stacked.pop("ffn_gate_exps"), stacked.pop("ffn_up_exps")
            stacked["ffn_gateup_exps"] = {k: torch.cat([g_f[k], u_f[k]], dim=axis)
                                          for k in g_f}
            rows_p = g_f["scale"].shape[axis]
            del g_f, u_f, layer_meta["ffn_gate_exps"], layer_meta["ffn_up_exps"]
            layer_meta["ffn_gateup_exps"] = QuantMeta(
                mg.ggml_type, mg.group, hp.n_expert * 2 * rows_p, mg.n_in,
                planes_t=mg.planes_t)
        params["layers"] = stacked
        if layer_meta:
            quant_meta["layers"] = layer_meta

    vocab = None
    if load_vocab and "tokenizer.ggml.tokens" in reader.kv:
        from ..tokenizer import Vocab

        vocab = Vocab.from_gguf(reader)
        if hp.n_vocab == 0:
            hp.n_vocab = vocab.n_tokens

    return LoadedModel(hparams=hp, params=params, reader=reader, vocab=vocab,
                       quant_meta=quant_meta or None, device=device)


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: arrays from JAX are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(params: dict, quant_meta: dict | None, hparams, device=None,
                      vocab=None) -> LoadedModel:
    """Carry a JAX-loaded model across: `params` is tpullama's
    LoadedModel.params converted to numpy (jax.tree.map(np.asarray, ...)),
    `quant_meta` its quant_meta and `hparams` its HParams. Returns the
    port's LoadedModel holding the same values (bf16 stays bf16, planes
    byte for byte)."""
    device = resolve_device(device)
    hp = HParams(**{f.name: getattr(hparams, f.name) for f in dataclasses.fields(HParams)})
    check_supported(hp)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _tensor_from_numpy(t, device)

    def meta(m):
        # the JAX package's K-sharded layout waits for the parallel modes
        if m.k_shards != 1:
            raise NotImplementedError(
                f"tpullama_torch: packed weights with k_shards={m.k_shards} are not ported")
        return QuantMeta(GGMLType(int(m.ggml_type)), int(m.group), int(m.n_out), int(m.n_in),
                         planes_t=bool(m.planes_t), order=str(m.order))

    qm = None
    if quant_meta:
        qm = {}
        for k, v in quant_meta.items():
            qm[k] = {kk: meta(vv) for kk, vv in v.items()} if isinstance(v, dict) else meta(v)
    return LoadedModel(hparams=hp, params=conv(params), reader=None, vocab=vocab,
                       quant_meta=qm, device=device)
