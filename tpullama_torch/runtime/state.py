"""Context/sequence state serialization (port of tpullama/runtime/state.py,
in the same file format).

The capability analog of the reference's three mechanisms:
 1. whole-context state blobs (llama_state_get/set_data)
 2. session files with a token prefix enabling prompt-cache reuse across
    runs (the CLI's --prompt-cache)
 3. per-sequence state files for server slot save/restore

Format: magic TPSN (context) / TPSQ (sequence), a little-endian uint32
version (1), a uint64 header length, a JSON header ({"fingerprint":
{arch, n_layer, n_head_kv, n_embd_head_k, n_embd_head_v, n_ctx,
kv_dtype}, "arrays": {name: {"shape", "dtype"}}}), then each array's raw
little-endian bytes in the header's order: kv_k (an int8 cache: kv_k/q,
kv_k/s), kv_v (kv_v/q, kv_v/s), kv_pos, pos_host, n_past and, if given,
tokens. A two-stack cache's leaves nest under its stacks, as the JAX
package flattens its {"full", "swa"} dicts: kv_k/full, kv_k/swa (int8:
kv_k/full/q, kv_k/full/s, ...), kv_v/..., kv_pos/full and kv_pos/swa;
pos_host is the full stack's. dtype names are numpy's ("float32", "int8", "int32", ...); a bf16
array is "bfloat16", its raw 2-byte patterns, as the JAX package writes
it through ml_dtypes. So a file written by either package restores in the
other. Restore validates the fingerprint the way the reference validates
n_embd/arch on session load, and writes the cache IN PLACE: the step
programs' CUDA graphs read it at fixed addresses.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

MAGIC_CTX = b"TPSN"
MAGIC_SEQ = b"TPSQ"
VERSION = 1

# torch dtypes by the numpy name the file carries
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
           "int8": torch.int8, "int32": torch.int32}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _leaves(tag: str, cache) -> dict:
    """A cache as 'tag' -> tensor, an int8 cache's (values, scales) pair as
    'tag/q' and 'tag/s' (the JAX package's flattened {"q", "s"} dict), a
    two-stack cache's stacks as 'tag/full/...' and 'tag/swa/...' (sorted
    keys, as the JAX package flattens its dicts)."""
    if isinstance(cache, dict):
        return {k: v for name in sorted(cache) for k, v in _leaves(f"{tag}/{name}",
                                                                    cache[name]).items()}
    if isinstance(cache, tuple):
        return {f"{tag}/q": cache[0], f"{tag}/s": cache[1]}
    return {tag: cache}


def _fingerprint(ctx) -> dict:
    hp = ctx.hp
    kv = next(iter(_leaves("kv_k", ctx.kv_k).values()))
    return {
        "arch": hp.arch,
        "n_layer": hp.n_layer,
        "n_head_kv": hp.n_head_kv,
        "n_embd_head_k": hp.n_embd_head_k,
        "n_embd_head_v": hp.n_embd_head_v,
        "n_ctx": ctx.p.n_ctx,
        "kv_dtype": _NAMES[kv.dtype],
    }


def _host(a) -> tuple[np.ndarray, str]:
    """An array's host bytes as a numpy array and its numpy dtype name (a
    bf16 tensor as its int16 patterns, named "bfloat16")."""
    if isinstance(a, np.ndarray):
        return np.ascontiguousarray(a), str(a.dtype)
    t = a.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), _NAMES[t.dtype]


def _write(f, magic: bytes, header: dict, arrays: dict) -> None:
    host = {k: _host(a) for k, a in arrays.items()}
    f.write(magic)
    f.write(struct.pack("<I", VERSION))
    hdr = dict(header)
    hdr["arrays"] = {k: {"shape": list(a.shape), "dtype": dt} for k, (a, dt) in host.items()}
    hb = json.dumps(hdr).encode()
    f.write(struct.pack("<Q", len(hb)))
    f.write(hb)
    for a, _dt in host.values():
        f.write(a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes())


def _read(f, magic: bytes) -> tuple[dict, dict]:
    """The header and each array as a CPU tensor."""
    m = f.read(4)
    if m != magic:
        raise ValueError(f"state file: bad magic {m!r}, expected {magic!r}")
    (ver,) = struct.unpack("<I", f.read(4))
    if ver > VERSION:
        raise ValueError(f"state file: unsupported version {ver}")
    (hlen,) = struct.unpack("<Q", f.read(8))
    hdr = json.loads(f.read(hlen))
    arrays = {}
    for name, meta in hdr["arrays"].items():
        dt = meta["dtype"]
        if dt not in _DTYPES:
            raise ValueError(f"state file: array {name} has unsupported dtype {dt}")
        np_dt = np.dtype("<i2") if dt == "bfloat16" else np.dtype(dt).newbyteorder("<")
        n = int(np.prod(meta["shape"])) if meta["shape"] else 1
        raw = f.read(n * np_dt.itemsize)
        if len(raw) != n * np_dt.itemsize:
            raise ValueError(f"state file: array {name} is truncated")
        a = torch.from_numpy(np.frombuffer(raw, np_dt).astype(np_dt.newbyteorder("="))
                             .reshape(meta["shape"]))
        arrays[name] = a.view(torch.bfloat16) if dt == "bfloat16" else a
    return hdr, arrays


def _open_read(src, magic: bytes) -> tuple[dict, dict]:
    if hasattr(src, "read"):
        return _read(src, magic)
    with open(src, "rb") as f:
        return _read(f, magic)


def _save(dest, magic: bytes, header: dict, arrays: dict) -> None:
    if hasattr(dest, "write"):
        _write(dest, magic, header, arrays)
    else:
        with open(dest, "wb") as f:
            _write(f, magic, header, arrays)


def _check(ctx, hdr: dict) -> None:
    fp, want = hdr["fingerprint"], _fingerprint(ctx)
    if fp != want:
        raise ValueError(f"state file: model/context mismatch: {fp} != {want}")


def _copy_in(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"state file: {name} has shape {tuple(src.shape)}, the context "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


def _array(arrays: dict, name: str) -> torch.Tensor:
    """The file's array `name`; a cache of another layout (one stack
    against two) fails by name."""
    if name not in arrays:
        raise ValueError(f"state file: no array {name} (the file holds "
                         f"{sorted(k for k in arrays if k.startswith(name.split('/')[0]))})")
    return arrays[name]


def _main_pos(arrays: dict) -> torch.Tensor:
    """The positions the host mirror follows: the full stack's."""
    return arrays.get("kv_pos", arrays.get("kv_pos/full"))


def _tokens(arrays: dict):
    toks = arrays.get("tokens")
    return None if toks is None else [int(t) for t in toks.tolist()]


def state_save(ctx, dest, tokens: list[int] | None = None) -> None:
    """Save the whole context state (+ optional session token prefix)."""
    arrays = {**_leaves("kv_k", ctx.kv_k), **_leaves("kv_v", ctx.kv_v),
              **_leaves("kv_pos", ctx.kv_pos), "pos_host": np.asarray(ctx._pos_host),
              "n_past": np.asarray(ctx.n_past)}
    if tokens is not None:
        arrays["tokens"] = np.asarray(tokens, np.int32)
    _save(dest, MAGIC_CTX, {"fingerprint": _fingerprint(ctx)}, arrays)


def state_load(ctx, src) -> list[int] | None:
    """Restore whole-context state in place. Returns the saved session
    tokens (for prompt-prefix reuse) or None."""
    hdr, arrays = _open_read(src, MAGIC_CTX)
    _check(ctx, hdr)
    for name, dst in {**_leaves("kv_k", ctx.kv_k), **_leaves("kv_v", ctx.kv_v),
                      **_leaves("kv_pos", ctx.kv_pos)}.items():
        _copy_in(dst, _array(arrays, name).to(dst.device), name)
    ctx._pos_host[:] = arrays.get("pos_host", _main_pos(arrays)).numpy()
    ctx.n_past[:] = arrays["n_past"].numpy()
    return _tokens(arrays)


def seq_save(ctx, seq_id: int, dest, tokens: list[int] | None = None) -> None:
    """Save one sequence lane (server slot save)."""
    arrays = {k: v[:, seq_id] for k, v in
              {**_leaves("kv_k", ctx.kv_k), **_leaves("kv_v", ctx.kv_v)}.items()}
    arrays.update({k: v[seq_id] for k, v in _leaves("kv_pos", ctx.kv_pos).items()})
    arrays["pos_host"] = np.asarray(ctx._pos_host[seq_id])
    arrays["n_past"] = np.asarray([ctx.n_past[seq_id]])
    if tokens is not None:
        arrays["tokens"] = np.asarray(tokens, np.int32)
    _save(dest, MAGIC_SEQ, {"fingerprint": _fingerprint(ctx)}, arrays)


def seq_load(ctx, seq_id: int, src) -> list[int] | None:
    """Restore one sequence lane into slot seq_id, in place."""
    hdr, arrays = _open_read(src, MAGIC_SEQ)
    _check(ctx, hdr)
    for name, dst in {**_leaves("kv_k", ctx.kv_k), **_leaves("kv_v", ctx.kv_v)}.items():
        _copy_in(dst[:, seq_id], _array(arrays, name).to(dst.device), name)
    for name, dst in _leaves("kv_pos", ctx.kv_pos).items():
        _copy_in(dst[seq_id], _array(arrays, name).to(dst.device), name)
    ctx._pos_host[seq_id] = arrays.get("pos_host", _main_pos(arrays)).numpy()
    ctx.n_past[seq_id] = int(arrays["n_past"][0])
    return _tokens(arrays)
