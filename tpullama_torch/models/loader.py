"""Model loader: GGUF -> PyTorch parameters on a device.

Port of tpullama/models/loader.py for the llama family (llama, mistral,
qwen2, chatglm, Mixtral-style MoE llama, the MoE archs qwen2moe, qwen3moe
and granitemoe with per-head q/k norms and shared experts, gpt-oss with
its attention sinks, attention output and router biases and per-expert
biases, the heterogeneous dense/MoE stacks of glm4moe, dots1,
ernie4_5-moe, bailingmoe2 and llama4 with interleaved MoE layers, the
MoE layers of llama4 and hunyuan-moe, the gemma and cohere families with
gemma2's and gemma3's post-attention and post-FFN norms, and the flag archs
of hparams.FLAG_ARCHS: orion's and stablelm's LayerNorm biases
(attn_norm, ffn_norm and output_norm), seed_oss's FFN norm stored as
post_attention_norm, the FFN biases of the non-gated archs (and of a
gated FFN that has them), falcon-40b's attn_norm_2, gpt2's and
starcoder's learned position table, bloom's embedding LayerNorm,
mpt's full-width q/k LayerNorm biases and chameleon's per-head ones
((n_head, head_dim), as the file holds them), bitnet's one-element
projection scales and its attention and FFN sub-norms, and chameleon's
swin norms remapped per file onto the post norms; olmo's file has no norm
tensors at all; a file without output.weight, as
gemma's, cohere's, glm4's, minicpm's and starcoder's tied ones are, takes
the token table as its lm_head). Every tensor the file holds is mapped or
refused by name, but the trailing NextN layers past hp.n_layer and every
blk.*.nextn.* tensor, which are skipped unread (glm4moe's and
bailingmoe2's multi-token-prediction head, which the forward never
runs). Per-layer tensors of equal shape are stacked along a leading
layer axis, as in the JAX package, so the two packages hold the same
arrays under the same names; the forward pass walks per-layer views of
the stacks. A heterogeneous stack (HParams.has_heterogeneous_layers) is a
per-layer list instead, params["layer_list"], one dict per layer with
every tensor dense in `dtype`, packed or not, as the JAX loader keeps it
(tpullama/models/loader.py:507-513); only `output` packs there.

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

Sources: a path or bytes (`load_model`), a list of split shards
(`load_model_from_splits`, and a first shard's path with split.count > 1
opens its siblings), or split futures whose bytes another thread fulfills
(`load_model_from_split_futures`, gguf/stream.py). Tensors are decoded and
repacked by the native host library (native.py) where it covers the type,
else by the numpy codecs, which give the same bytes. `progress_callback`
is called once per tensor with the fraction loaded; returning False
cancels the load (InterruptedError), as in the JAX package.

`params_from_numpy` carries a JAX-loaded model's parameters across (as
numpy arrays), so both packages can be held against each other on the
same bytes.
"""

from __future__ import annotations

import concurrent.futures as _fut
import dataclasses
import math
import os
import re
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..gguf import GGMLType, GGUFReader
from ..gguf.quants import dequantize
from ..native import (_NATIVE_DEQ_TYPES, _NATIVE_REPACK_TYPES, native_dequantize,
                      native_repack, resolve_native)
from ..ops.cuda.fused_layer import resolve_fused_layer
from ..ops.cuda.qmm_gathered import PLANES_T_FIELDS
from ..ops.qweights import (PACKED_TYPES, PlanarQuant, mxfp4_to_ar, repack, to_fourblock,
                            transpose_planes)
from .hparams import HParams, check_arch
from .llama import ffn_act

# per-layer tensor suffixes of the llama family -> param names
_LAYER_TENSORS = {
    "attn_norm.weight": "attn_norm",
    # LayerNorm biases (orion, stablelm)
    "attn_norm.bias": "attn_norm_bias",
    "ffn_norm.bias": "ffn_norm_bias",
    "attn_q.weight": "attn_q",
    "attn_k.weight": "attn_k",
    "attn_v.weight": "attn_v",
    "attn_output.weight": "attn_output",
    "attn_qkv.weight": "attn_qkv",
    "attn_qkv.bias": "attn_qkv_bias",
    "attn_q.bias": "attn_q_bias",
    "attn_k.bias": "attn_k_bias",
    "attn_v.bias": "attn_v_bias",
    "attn_q_norm.weight": "attn_q_norm",
    "attn_k_norm.weight": "attn_k_norm",
    # the full-width q/k LayerNorms' biases (mpt)
    "attn_q_norm.bias": "attn_q_norm_bias",
    "attn_k_norm.bias": "attn_k_norm_bias",
    "ffn_norm.weight": "ffn_norm",
    "ffn_gate.weight": "ffn_gate",
    "ffn_up.weight": "ffn_up",
    "ffn_down.weight": "ffn_down",
    "ffn_gate_inp.weight": "ffn_gate_inp",
    "ffn_gate_exps.weight": "ffn_gate_exps",
    "ffn_up_exps.weight": "ffn_up_exps",
    "ffn_down_exps.weight": "ffn_down_exps",
    "ffn_gate_inp_shexp.weight": "ffn_gate_inp_shexp",
    "ffn_gate_shexp.weight": "ffn_gate_shexp",
    "ffn_up_shexp.weight": "ffn_up_shexp",
    "ffn_down_shexp.weight": "ffn_down_shexp",
    "exp_probs_b.bias": "exp_probs_b",
    "attn_output.bias": "attn_output_bias",
    "ffn_gate_inp.bias": "ffn_gate_inp_b",
    "attn_sinks.weight": "attn_sinks",
    # gemma2's and gemma3's sandwich norms: after o-proj and after ffn_down
    "post_attention_norm.weight": "post_attn_norm",
    "post_ffw_norm.weight": "post_ffn_norm",
    # per-expert biases (gpt-oss)
    "ffn_gate_exps.bias": "ffn_gate_exps_b",
    "ffn_up_exps.bias": "ffn_up_exps_b",
    "ffn_down_exps.bias": "ffn_down_exps_b",
    # FFN biases (the non-gated archs' up and down; a gated FFN's gate, up
    # and down) and falcon-40b's second attention norm, which its FFN reads
    "ffn_up.bias": "ffn_up_bias",
    "ffn_down.bias": "ffn_down_bias",
    "ffn_gate.bias": "ffn_gate_bias",
    "attn_norm_2.weight": "attn_norm_2",
    "attn_norm_2.bias": "attn_norm_2_bias",
    # bitnet: one-element scales multiplied after each projection, and the
    # RMS sub-norms before attn_output and before ffn_down
    "attn_q.scale": "attn_q_scale",
    "attn_k.scale": "attn_k_scale",
    "attn_v.scale": "attn_v_scale",
    "attn_output.scale": "attn_output_scale",
    "ffn_gate.scale": "ffn_gate_scale",
    "ffn_up.scale": "ffn_up_scale",
    "ffn_down.scale": "ffn_down_scale",
    "attn_sub_norm.weight": "attn_sub_norm",
    "ffn_sub_norm.weight": "ffn_sub_norm",
}
# per-arch remaps of tensor suffixes onto forward roles: glm4moe, gpt-oss
# and seed_oss normalize ffn_inp with post_attention_norm, the ffn_norm
# slot (the JAX loader's _ARCH_TENSOR_OVERRIDES; models/glm4-moe.cpp:93-96,
# models/openai-moe-iswa.cpp:80-86, models/seed-oss.cpp:86), where gemma's
# and glm4's post-scale the attention output
_ARCH_TENSOR_OVERRIDES = {"glm4moe": {"post_attention_norm.weight": "ffn_norm"},
                          "gpt-oss": {"post_attention_norm.weight": "ffn_norm"},
                          "seed_oss": {"post_attention_norm.weight": "ffn_norm"}}
# chameleon's swin variant (hp.swin_norm, a key of the file): attn_norm and
# ffn_norm norm the block outputs before the residual adds, the post norms'
# slots (the JAX loader's per-file remap, loader.py:380-385;
# models/chameleon.cpp:27,107-136)
_SWIN_OVERRIDES = {"attn_norm.weight": "post_attn_norm", "ffn_norm.weight": "post_ffn_norm"}
_EXPERT_TRIO = ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")
# the layer matrices the fused post-attention path reads in fourblock order
_FOURBLOCK_KEYS = ("attn_output", "ffn_up", "ffn_down")

_TOP_TENSORS = {
    "token_embd.weight": "tok_embd",
    "output_norm.weight": "output_norm",
    "output_norm.bias": "output_norm_bias",
    "output.weight": "output",
    "output.bias": "output_bias",
    "rope_freqs.weight": "rope_freqs",
    # learned absolute positions (gpt2, starcoder), dense in `dtype`
    "position_embd.weight": "position_embd",
    # the embedding LayerNorm after the token rows (bloom)
    "token_embd_norm.weight": "token_embd_norm",
    "token_embd_norm.bias": "token_embd_norm_bias",
}
# the archs whose MoE layers the port runs (ops/moe.py)
_MOE_ARCHS = ("llama", "qwen2moe", "qwen3moe", "granitemoe", "glm4moe", "dots1", "ernie4_5-moe",
              "bailingmoe2", "gpt-oss", "llama4", "hunyuan-moe", "olmoe")

# values dequantized per host batch when a large dense tensor is decoded
_DENSE_ELEMS = 8192 * 4096


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
            if isinstance(t, list):
                return sum(walk(v) for v in t)
            return t.numel() * t.element_size()

        return walk(self.params)


def check_supported(hp: HParams) -> None:
    """Raise for anything outside the slices ported: the llama family
    (chatglm, gemma and cohere included), MoE on the llama arch (Mixtral)
    and the MoE archs of _MOE_ARCHS, and sliding-window attention where a
    ported arch lays out its SWA layers (gpt-oss, gemma2, gemma3, cohere2;
    llama4's chunked windows); any other SWA model, and a chunked window
    on another arch, by name with their ROADMAP item; an FFN activation
    outside models/llama.FFN_ACTS by the arch and its name."""
    check_arch(hp.arch)
    ffn_act(hp)
    chunked_ok = hp.swa_type == "chunked" and hp.arch == "llama4"
    if hp.n_swa and (not hp.swa_layers or (hp.swa_type != "standard" and not chunked_ok)):
        what = "chunked attention" if hp.swa_type == "chunked" else "sliding-window attention"
        raise NotImplementedError(
            f"tpullama_torch: {hp.arch!r} with {what} is not ported yet "
            "(ROADMAP.md Queue 1 item 7)")
    if hp.n_expert and hp.arch not in _MOE_ARCHS:
        raise NotImplementedError(f"tpullama_torch: {hp.arch!r} with MoE is not ported yet")


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


def repack_rows(raw: np.ndarray, ggml_type: GGMLType, n_rows: int, K: int) -> PlanarQuant:
    """The numpy codecs' repack of an (n_rows, K) matrix, in row batches of
    about _DENSE_ELEMS values on the host's threads (numpy releases the
    GIL): every plane is per row, so the batches' planes stacked are one
    call's."""
    step = max(1, _DENSE_ELEMS // K)
    if n_rows <= step:
        return repack(raw, ggml_type, (n_rows, K))
    per_row = raw.size // n_rows

    def rows(r0: int) -> PlanarQuant:
        r1 = min(n_rows, r0 + step)
        return repack(raw[r0 * per_row:r1 * per_row], ggml_type, (r1 - r0, K))

    starts = range(0, n_rows, step)
    with _fut.ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as pool:
        parts = list(pool.map(rows, starts))
    return PlanarQuant(ggml_type, (n_rows, K),
                       {k: np.concatenate([p.fields[k] for p in parts]) for k in parts[0].fields},
                       parts[0].group)


def resolve_mxfp4_ar(value: bool | None) -> bool:
    """Whether packed MXFP4 layer matrices are re-coded to the A/r planes
    (ops/qweights.mxfp4_to_ar): `value`, else the TPULLAMA_MXFP4_AR
    environment variable set to "1", the JAX loader's switch."""
    if value is not None:
        return bool(value)
    return os.environ.get("TPULLAMA_MXFP4_AR", "0") == "1"


def _torch_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        return getattr(torch, d)
    return torch.from_numpy(np.zeros(0, np.dtype(d))).dtype


def _progress_noop(frac: float) -> bool:
    return True


class _MultiReader:
    """Union view over split GGUF shards (tools/gguf-split layout): kv
    from shard 0, tensors from all shards."""

    def __init__(self, readers):
        self.readers = readers
        self.kv = readers[0].kv
        self.tensors = {}
        self._where = {}
        for r in readers:
            for name, info in r.tensors.items():
                self.tensors[name] = info
                self._where[name] = r
        self.alignment = readers[0].alignment

    def tensor_raw(self, name):
        return self._where[name].tensor_raw(name)

    def tensor_f32(self, name):
        return self._where[name].tensor_f32(name)


def load_model_from_splits(sources: list, **kw) -> LoadedModel:
    """Load from an explicit list of shard paths or buffers
    (llama_model_load_from_splits); `kw` as load_model's."""
    return load_model(_MultiReader([GGUFReader(s) for s in sources]), **kw)


def load_model_from_split_futures(keys: list[str], context: str, registry=None,
                                  timeout: float | None = None, **kw) -> LoadedModel:
    """Async split-future loading (the fork's
    llama_model_load_from_split_futures): blocks on each split's future
    until another thread fulfills its bytes through
    tpullama_torch.gguf.fulfill_split_future(key, context, data), then
    drops the context's futures; `kw` as load_model's."""
    from ..gguf.stream import GLOBAL_REGISTRY

    reg = registry or GLOBAL_REGISTRY
    readers = [GGUFReader(reg.register(key, context).extract(timeout=timeout)) for key in keys]
    reg.release_context(context)
    return load_model(_MultiReader(readers), **kw)


def load_model(source, dtype=torch.float32, device=None, packed: bool = False,
               packed_scale_dtype=torch.bfloat16, load_vocab: bool = True,
               fused_layer: bool | None = None,
               progress_callback=_progress_noop, native: bool | None = None,
               mxfp4_ar: bool | None = None) -> LoadedModel:
    """Load a llama-family GGUF (path, bytes, or the union of split shards
    from load_model_from_splits) onto `device` (default cuda; raises
    without a GPU unless device="cpu" is passed). A path to the first
    shard of a split model (split.count > 1) loads every shard.

    `packed=True` keeps supported quantized 2-D weights in planar packed
    form for the fused dequant-matmul kernel; their scale/min planes are
    stored in `packed_scale_dtype` (bf16 by default, as in the JAX
    package; pass torch.float32 for bit-exact planes). `fused_layer`
    (default: the TPULLAMA_FUSED_LAYER environment variable, as the JAX
    loader reads it) stores the packed {q4, scale, minv} attn_output,
    ffn_up and ffn_down in fourblock order for the fused post-attention
    kernel. `progress_callback(frac)` is called once per tensor; returning
    False cancels the load (InterruptedError). `native` (default: on
    unless TPULLAMA_NO_NATIVE is set, read once here) decodes and repacks
    through the native host library where it covers the type. `mxfp4_ar`
    (default: TPULLAMA_MXFP4_AR set to "1", read once here) re-codes every
    packed MXFP4 layer matrix, dense and expert stacks alike, to the A/r
    planes {q4a, q1r, scale} (ops/qweights.mxfp4_to_ar), where the JAX
    loader does (tpullama/models/loader.py:556-565); the output matrix keeps
    its LUT planes, as there."""
    kw = dict(dtype=dtype, device=device, packed=packed, packed_scale_dtype=packed_scale_dtype,
              load_vocab=load_vocab, fused_layer=fused_layer,
              progress_callback=progress_callback, native=native, mxfp4_ar=mxfp4_ar)
    if isinstance(source, _MultiReader):
        reader = source
    else:
        reader = GGUFReader(source)
        if (int(reader.kv.get("split.count", 0) or 0) > 1
                and isinstance(source, (str, os.PathLike))):
            # the first shard of a split model: open its siblings
            from ..tools.gguf_split import shard_paths_from_first

            return load_model_from_splits(shard_paths_from_first(os.fspath(source)), **kw)
    device = resolve_device(device)
    fused_layer = resolve_fused_layer(fused_layer)
    native = resolve_native(native)
    mxfp4_ar = resolve_mxfp4_ar(mxfp4_ar)
    dtype = _torch_dtype(dtype)
    sdt = _torch_dtype(packed_scale_dtype) if packed_scale_dtype is not None else torch.float32
    hp = HParams.from_gguf(reader)
    check_supported(hp)

    layer_names: dict[int, dict[str, str]] = {}
    top: dict[str, str] = {}
    overrides = {**_ARCH_TENSOR_OVERRIDES.get(hp.arch, {}),
                 **(_SWIN_OVERRIDES if hp.swin_norm else {})}
    skipped = 0
    pat = re.compile(r"^blk\.(\d+)\.(.+)$")
    for name in reader.tensors:
        m = pat.match(name)
        if m:
            il, suffix = int(m.group(1)), m.group(2)
            if (hp.nextn_layers and il >= hp.n_layer) or suffix.startswith("nextn."):
                # a NextN layer (or its extras): never read
                skipped += 1
                continue
            pname = overrides.get(suffix, _LAYER_TENSORS.get(suffix))
            if pname is None:
                raise NotImplementedError(f"tpullama_torch: tensor {name!r} is not ported yet")
            layer_names.setdefault(il, {})[pname] = name
        elif name in _TOP_TENSORS:
            top[_TOP_TENSORS[name]] = name
        else:
            raise NotImplementedError(f"tpullama_torch: tensor {name!r} is not ported yet")
    n_layer = hp.n_layer or (max(layer_names) + 1 if layer_names else 0)
    total = len(reader.tensors) - skipped
    done = 0

    def tick() -> None:
        nonlocal done
        done += 1
        if not progress_callback(done / max(total, 1)):
            raise InterruptedError("model load cancelled by progress callback")

    def decode(raw: np.ndarray, ggml_type: GGMLType, shape: tuple) -> np.ndarray:
        arr = native_dequantize(raw, ggml_type, math.prod(shape)) if native else None
        return arr.reshape(shape) if arr is not None else dequantize(raw, ggml_type, shape)

    def decode_into(raw: np.ndarray, ggml_type: GGMLType, shape: tuple, out: np.ndarray):
        """Dequantize into `out`, a contiguous f32 array of prod(shape)."""
        if native and native_dequantize(raw, ggml_type, out.size, out=out) is not None:
            return
        out[:] = dequantize(raw, ggml_type, shape).reshape(-1)

    staging: list = []  # (pinned host, device) f32 buffers, reused

    def stage(n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """f32 buffers through which rows reach the card: decoded into
        page-locked host memory, copied as f32, converted there (a copy
        that changes dtype on its way to the card converts on one host
        thread)."""
        if not staging or staging[0][0].numel() < n:
            n_alloc = max(n, _DENSE_ELEMS)
            staging[:] = [(torch.empty(n_alloc, pin_memory=True),
                           torch.empty(n_alloc, device=device))]
        host, dev = staging[0]
        return host[:n], dev[:n]

    def packable(tname: str, allow_3d: bool = False) -> bool:
        info = reader.tensors[tname]
        return (packed and (len(info.shape) == 2 or (allow_3d and len(info.shape) == 3))
                and info.ggml_type in PACKED_TYPES and info.shape[-1] % 256 == 0)

    def fetch_dense(tname: str, out: torch.Tensor) -> None:
        """Dequantize a tensor into `out` (any device), in row batches; into
        host memory by the numpy codecs (no native library, or a type it
        does not decode), the batches run on the host's threads (numpy
        releases the GIL), each writing its own rows."""
        info = reader.tensors[tname]
        raw = reader.tensor_raw(tname)
        if len(info.shape) < 2:
            out.copy_(torch.from_numpy(decode(raw, info.ggml_type, info.shape)))
            tick()
            return
        rows, K = int(np.prod(info.shape[:-1])), info.shape[-1]
        per_row = raw.size // rows
        flat = out.view(rows, K)
        step = max(1, _DENSE_ELEMS // K)

        def batch(r0: int) -> None:
            r1 = min(rows, r0 + step)
            part, shape = raw[r0 * per_row:r1 * per_row], (r1 - r0, K)
            if out.device.type != "cpu":
                host, dev = stage((r1 - r0) * K)
                decode_into(part, info.ggml_type, shape, host.numpy())
                dev.copy_(host)
                flat[r0:r1].copy_(dev.view(shape))
            elif out.dtype == torch.float32:
                decode_into(part, info.ggml_type, shape, flat[r0:r1].numpy().reshape(-1))
            else:
                flat[r0:r1].copy_(torch.from_numpy(decode(part, info.ggml_type, shape)))

        starts = range(0, rows, step)
        by_numpy = not (native and info.ggml_type in _NATIVE_DEQ_TYPES)
        if out.device.type == "cpu" and by_numpy and len(starts) > 1:
            with _fut.ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as pool:
                list(pool.map(batch, starts))
        else:
            for r0 in starts:
                batch(r0)
        tick()

    def fetch_packed(tname: str, key: str | None = None) -> tuple[dict, QuantMeta]:
        """A tensor's planes and meta. Expert tensors come back as
        (n_expert, ...) planes; every other one as (1, n_out, kcols), in
        fourblock order where the fused layer reads layer matrix `key`
        (the JAX loader's condition, loader.py:629-642). A layer matrix
        (`key` given) in MXFP4 is re-coded to the A/r planes with
        `mxfp4_ar`, before the expert planes' layout is chosen, as in the
        JAX loader."""
        info = reader.tensors[tname]
        n_rows, K = int(np.prod(info.shape[:-1])), info.shape[-1]
        raw = reader.tensor_raw(tname)
        res = native_repack(raw, info.ggml_type, n_rows, K) if native else None
        pq = (PlanarQuant(info.ggml_type, (n_rows, K), *res) if res is not None
              else repack_rows(raw, info.ggml_type, n_rows, K))
        if mxfp4_ar and key is not None and pq.ggml_type == GGMLType.MXFP4:
            pq = PlanarQuant(pq.ggml_type, pq.shape, mxfp4_to_ar(pq.fields), pq.group)
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
            tick()
        else:
            t = torch.empty(info.shape, dtype=dtype if pname != "rope_freqs" else torch.float32,
                            device=device)
            fetch_dense(tname, t)
            params[pname] = t

    if n_layer and hp.has_heterogeneous_layers:
        # each layer its own dict, every tensor dense in `dtype`
        layer_list = []
        for il in range(n_layer):
            layer = {}
            for pname, tname in sorted(layer_names.get(il, {}).items()):
                layer[pname] = torch.empty(reader.tensors[tname].shape, dtype=dtype,
                                           device=device)
                fetch_dense(tname, layer[pname])
            layer_list.append(layer)
        params["layer_list"] = layer_list
    elif n_layer:
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
        # repack on host threads (numpy and the native library release the
        # GIL; the native library runs its own threads, so two workers
        # suffice where it repacks every job; the numpy codecs, for the
        # types it does not repack, scale with the host's threads), copy
        # each layer's planes into the device stack as it completes
        work = [(key, il, tn) for key, tnames in jobs for il, tn in enumerate(tnames)]
        all_native = native and all(
            reader.tensors[tn].ggml_type in _NATIVE_REPACK_TYPES
            and reader.tensors[tn].shape[-1] <= 16384 for _k, _il, tn in work)
        n_workers = max(1, min(2 if all_native else 8, os.cpu_count() or 1))
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
                tick()
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
        if isinstance(t, list):  # a heterogeneous stack's layer_list
            return [conv(v) for v in t]
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
