"""The port's state files (tpullama_torch/runtime/state.py) held against the
JAX package's (tpullama/runtime/state.py) on the CPU: the same format, so a
file written by either package restores in the other. Fixture:
make_tiny_llama_gguf (n_embd 64, 2 layers, dense F32), Contexts of 96 cells
with f32 activations and an f32 or int8 cache (a bf16 cache for the
byte-level check).

Tolerances: a continuation after a restore must give exactly the tokens the
writer's own continuation gives; a file read back restores the cache, the
positions, n_past and the tokens bit for bit; the header of a port file
equals the JAX package's for the same context; bf16 rows cross as their
raw 2-byte patterns, bit for bit."""

import io
import json
import struct

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tpullama.models.testing import make_tiny_llama_gguf

PROMPT = "The quick brown fox"


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from tpullama.models import load_model as j_load
    from tpullama_torch.models import load_model as t_load

    p = str(tmp_path_factory.mktemp("st") / "m.gguf")
    make_tiny_llama_gguf(p, n_layer=2, seed=50)
    return {"jax": j_load(p), "torch": t_load(p, device="cpu")}


def _ctx(models, pkg, kv, n_ctx=96, n_seqs=1, dtype="float32"):
    if pkg == "jax":
        import jax.numpy as jnp

        from tpullama.runtime import Context, ContextParams

        dt = {"float32": jnp.float32, "int8": jnp.int8, "bfloat16": jnp.bfloat16}
    else:
        from tpullama_torch.runtime import Context, ContextParams

        dt = {"float32": torch.float32, "int8": torch.int8, "bfloat16": torch.bfloat16}
    return Context(models[pkg], ContextParams(n_ctx=n_ctx, n_seqs=n_seqs, dtype=dt[dtype],
                                              kv_dtype=dt[kv]))


def _state(pkg):
    if pkg == "jax":
        from tpullama.runtime import state
    else:
        from tpullama_torch.runtime import state
    return state


def _greedy(ctx, tok, n, seq_id=0):
    out = []
    for _ in range(n):
        tok = int(np.argmax(ctx.decode(np.asarray([tok], np.int32), seq_id=seq_id)[-1]))
        out.append(tok)
    return out


@pytest.mark.parametrize("kind", ["state", "seq"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_files_restore_across_packages(models, tmp_path, writer, reader, kv, kind):
    """A context (or lane 0 of two) prefilled and 5 greedy tokens on, saved
    by one package, restored by the other (a fresh context; a sequence
    into lane 1), continues with the writer's 6 next tokens."""
    toks = models["torch"].vocab.tokenize(PROMPT, add_special=True)
    n_seqs = 2 if kind == "seq" else 1
    src = _ctx(models, writer, kv, n_seqs=n_seqs)
    part = src.generate(toks, n_predict=5) if kind == "state" else []
    if kind == "seq":
        src.decode(np.asarray(toks, np.int32), seq_id=0)
        part = _greedy(src, toks[-1], 5)
    path = str(tmp_path / "s.bin")
    if kind == "state":
        _state(writer).state_save(src, path, tokens=toks + part)
    else:
        _state(writer).seq_save(src, 0, path, tokens=toks + part)
    want = _greedy(src, part[-1], 6)
    dst = _ctx(models, reader, kv, n_seqs=n_seqs)
    if kind == "state":
        got_toks = _state(reader).state_load(dst, path)
        lane = 0
    else:
        got_toks = _state(reader).seq_load(dst, 1, path)
        lane = 1
    assert [int(t) for t in got_toks] == toks + part
    assert int(dst.n_past[lane]) == int(src.n_past[0]) - 6
    assert _greedy(dst, part[-1], 6, seq_id=lane) == want


def _leaves(c):
    return list(c) if isinstance(c, tuple) else [c]


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_port_file_read_back_is_bit_for_bit(models, kv):
    from tpullama_torch.runtime.state import seq_load, seq_save, state_load, state_save

    toks = models["torch"].vocab.tokenize(PROMPT, add_special=True)
    dtype = "bfloat16" if kv == "bfloat16" else "float32"
    a = _ctx(models, "torch", kv, n_seqs=2, dtype=dtype)
    a.decode(np.asarray(toks), seq_id=0)
    a.decode(np.asarray(toks[:3]), seq_id=1)
    buf = io.BytesIO()
    state_save(a, buf, tokens=toks)
    buf.seek(0)
    b = _ctx(models, "torch", kv, n_seqs=2, dtype=dtype)
    kept = [t.data_ptr() for c in (b.kv_k, b.kv_v) for t in _leaves(c)]
    assert state_load(b, buf) == toks
    for x, y in zip(_leaves(a.kv_k) + _leaves(a.kv_v), _leaves(b.kv_k) + _leaves(b.kv_v)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # restored in place: the step programs' graphs read these addresses
    assert [t.data_ptr() for c in (b.kv_k, b.kv_v) for t in _leaves(c)] == kept
    assert torch.equal(a.kv_pos, b.kv_pos)
    np.testing.assert_array_equal(a._pos_host, b._pos_host)
    np.testing.assert_array_equal(a.n_past, b.n_past)
    buf = io.BytesIO()
    seq_save(a, 1, buf)
    buf.seek(0)
    c = _ctx(models, "torch", kv, n_seqs=2, dtype=dtype)
    assert seq_load(c, 0, buf) is None
    for x, y in zip(_leaves(a.kv_k) + _leaves(a.kv_v), _leaves(c.kv_k) + _leaves(c.kv_v)):
        assert torch.equal(x[:, 1], y[:, 0])
    assert torch.equal(a.kv_pos[1], c.kv_pos[0]) and int(c.n_past[0]) == 3


def _header(raw: bytes) -> dict:
    (hlen,) = struct.unpack("<Q", raw[8:16])
    return json.loads(raw[16:16 + hlen])


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_headers_and_bf16_bytes_equal_the_reference(models, kv):
    """The same context in both packages writes the same magic, version and
    JSON header (fingerprint, array names, shapes, dtype names, in order);
    a bf16 cache's rows cross as their 2-byte patterns."""
    toks = models["torch"].vocab.tokenize(PROMPT, add_special=True)
    dtype = "bfloat16" if kv == "bfloat16" else "float32"
    raws = {}
    for pkg in ("jax", "torch"):
        c = _ctx(models, pkg, kv, n_ctx=64, dtype=dtype)
        c.decode(np.asarray(toks))
        for kind in ("state", "seq"):
            buf = io.BytesIO()
            if kind == "state":
                _state(pkg).state_save(c, buf, tokens=toks)
            else:
                _state(pkg).seq_save(c, 0, buf, tokens=toks)
            raws[pkg, kind] = buf.getvalue()
    for kind, magic in (("state", b"TPSN"), ("seq", b"TPSQ")):
        j, t = raws["jax", kind], raws["torch", kind]
        assert t[:8] == j[:8] == magic + struct.pack("<I", 1)
        hj, ht = _header(j), _header(t)
        assert ht == hj and list(ht["arrays"]) == list(hj["arrays"])
        assert ht["fingerprint"]["kv_dtype"] == kv
        assert len(t) == len(j)
    if kv == "bfloat16":
        jc = _ctx(models, "jax", kv, n_ctx=64, dtype=dtype)
        _state("jax").state_load(jc, io.BytesIO(raws["torch", "state"]))
        tc = _ctx(models, "torch", kv, n_ctx=64, dtype=dtype)
        _state("torch").state_load(tc, io.BytesIO(raws["torch", "state"]))
        np.testing.assert_array_equal(np.asarray(jc.kv_k).view(np.uint16),
                                      tc.kv_k.view(torch.int16).numpy().view(np.uint16))


def test_fingerprint_mismatch_and_bad_magic_raise(models, tmp_path):
    from tpullama_torch.runtime.state import seq_load, state_load, state_save

    a = _ctx(models, "torch", "float32", n_ctx=64)
    path = str(tmp_path / "s.bin")
    state_save(a, path)
    for other in (_ctx(models, "torch", "float32", n_ctx=96),
                  _ctx(models, "torch", "int8", n_ctx=64)):
        with pytest.raises(ValueError, match="mismatch"):
            state_load(other, path)
    with pytest.raises(ValueError, match="magic"):
        seq_load(a, 0, path)  # a context file is no sequence file
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"NOPE" + b"\x00" * 64)
    with pytest.raises(ValueError, match="magic"):
        state_load(a, str(junk))
    # the JAX package refuses a port file of another context the same way
    with pytest.raises(ValueError, match="mismatch"):
        _state("jax").state_load(_ctx(models, "jax", "float32", n_ctx=96), path)


def test_engine_slot_restore_reuses_the_prefix_and_refuses_a_busy_slot(models, tmp_path):
    """ServerEngine.slot_save / slot_restore (synchronous mode): a restored
    slot's cache_tokens are the saved ones, so the same prompt again reuses
    its prefix (perf.n_reused) and gives the same tokens; a slot that is
    processing a request refuses a restore; an unknown slot raises."""
    from tpullama_torch.server.engine import ServerEngine, SlotState

    eng = ServerEngine(models["torch"], n_slots=2, n_ctx=96)
    prompt = models["torch"].vocab.tokenize(PROMPT, add_special=True)
    first = eng.complete("The quick brown fox", n_predict=6)
    path = str(tmp_path / "slot.bin")
    saved = eng.slot_save(0, path)
    assert saved["n_saved"] == len(eng.slots[0].cache_tokens) > len(prompt)
    eng.slot_erase(0)
    assert eng.slots[0].cache_tokens == [] and int(eng.ctx.n_past[0]) == 0
    restored = eng.slot_restore(0, path)
    assert restored["n_restored"] == saved["n_saved"]
    reused = eng.ctx.perf.n_reused
    again = eng.complete("The quick brown fox", n_predict=6)
    assert again.out_tokens == first.out_tokens
    assert eng.ctx.perf.n_reused - reused == len(prompt) - 1
    eng.slots[1].state = SlotState.PROMPT
    with pytest.raises(RuntimeError, match="busy"):
        eng.slot_restore(1, path)
    with pytest.raises(IndexError):
        eng.slot_save(5, path)
