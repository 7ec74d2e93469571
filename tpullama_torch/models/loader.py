"""Model loader: GGUF -> PyTorch parameters on a device.

Port of tpullama/models/loader.py for the llama family (llama, mistral,
qwen2 without MoE). Per-layer tensors of equal shape are stacked along a
leading layer axis, as in the JAX package, so the two packages hold the
same arrays under the same names; the forward pass walks per-layer views
of the stacks.

Two weight modes:
  - dense (default): blocks decoded to `dtype` at load.
  - packed: supported quantized 2-D weights repacked into the planar
    layout of ops/qweights.py (uint8 planes + scale/min planes), byte for
    byte the JAX package's planes, for the fused dequant-matmul kernel.
    Only `output` among the top-level tensors is packed; the token table
    stays dense, as in the JAX package.

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
from ..ops.qweights import PACKED_TYPES, PlanarQuant, repack
from .hparams import LLAMA_FAMILY, HParams

# per-layer tensor suffixes of the llama family -> param names
_LAYER_TENSORS = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "attn_q",
    "attn_k.weight": "attn_k",
    "attn_v.weight": "attn_v",
    "attn_output.weight": "attn_output",
    "attn_q.bias": "attn_q_bias",
    "attn_k.bias": "attn_k_bias",
    "attn_v.bias": "attn_v_bias",
    "ffn_norm.weight": "ffn_norm",
    "ffn_gate.weight": "ffn_gate",
    "ffn_up.weight": "ffn_up",
    "ffn_down.weight": "ffn_down",
}

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
    """Raise for anything outside the slice: the plain llama family."""
    if hp.arch not in LLAMA_FAMILY:
        raise NotImplementedError(f"tpullama_torch: arch {hp.arch!r} is not ported yet")
    if hp.n_expert or hp.n_swa:
        raise NotImplementedError(
            f"tpullama_torch: {hp.arch!r} with MoE or sliding-window attention is not "
            "ported yet")


def _torch_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        return getattr(torch, d)
    return torch.from_numpy(np.zeros(0, np.dtype(d))).dtype


def load_model(source, dtype=torch.float32, device=None, packed: bool = False,
               packed_scale_dtype=torch.bfloat16, load_vocab: bool = True) -> LoadedModel:
    """Load a llama-family GGUF (path or bytes) onto `device` (default
    cuda; raises without a GPU unless device="cpu" is passed).

    `packed=True` keeps supported quantized 2-D weights in planar packed
    form for the fused dequant-matmul kernel; their scale/min planes are
    stored in `packed_scale_dtype` (bf16 by default, as in the JAX
    package; pass torch.float32 for bit-exact planes)."""
    device = resolve_device(device)
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

    def packable(tname: str) -> bool:
        info = reader.tensors[tname]
        return (packed and len(info.shape) == 2 and info.ggml_type in PACKED_TYPES
                and info.shape[-1] % 256 == 0)

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

    def fetch_packed(tname: str) -> PlanarQuant:
        info = reader.tensors[tname]
        n_rows = int(np.prod(info.shape[:-1]))
        return repack(reader.tensor_raw(tname), info.ggml_type, (n_rows, info.shape[-1]))

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
            pq = fetch_packed(tname)
            params[pname] = {k: to_device(v, k in ("scale", "minv")) for k, v in pq.fields.items()}
            quant_meta[pname] = QuantMeta(pq.ggml_type, pq.group, *pq.shape)
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
        for key in keys:
            tnames = [layer_names[il][key] for il in range(n_layer)]
            types = {reader.tensors[t].ggml_type for t in tnames}
            # a packed stack needs one type across layers (mixed per-layer
            # types fall back to dense for that tensor, as in the JAX loader)
            if len(types) == 1 and packable(tnames[0]):
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
            futs = {pool.submit(fetch_packed, tn): (key, il) for key, il, tn in work}
            for f in _fut.as_completed(futs):
                key, il = futs[f]
                pq = f.result()
                if key not in stacked:
                    stacked[key] = {
                        k: torch.empty((n_layer, *v.shape),
                                       dtype=(sdt if k in ("scale", "minv")
                                              else torch.from_numpy(v[:0]).dtype),
                                       device=device)
                        for k, v in pq.fields.items()
                    }
                    layer_meta[key] = QuantMeta(pq.ggml_type, pq.group, *pq.shape)
                for k, v in pq.fields.items():
                    stacked[key][k][il].copy_(to_device(v, k in ("scale", "minv")))
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
        return QuantMeta(GGMLType(int(m.ggml_type)), int(m.group), int(m.n_out), int(m.n_in))

    qm = None
    if quant_meta:
        qm = {}
        for k, v in quant_meta.items():
            qm[k] = {kk: meta(vv) for kk, vv in v.items()} if isinstance(v, dict) else meta(v)
    return LoadedModel(hparams=hp, params=conv(params), reader=None, vocab=vocab,
                       quant_meta=qm, device=device)
