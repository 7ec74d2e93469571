"""The port's memory and split-future sources (tpullama_torch.gguf.stream, a
copy of tpullama/gguf/stream.py), the copied gguf-split tool, and the
loader's split and progress paths (load_model_from_splits,
load_model_from_split_futures, a first shard's path, progress_callback),
held against the JAX package: the registry behaves as the original's, and
every split source gives parameters equal to a whole-file load, bit for
bit; the progress fractions are the JAX loader's."""

import threading
import time

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tpullama.gguf import GGMLType
from tpullama.gguf import stream as j_stream
from tpullama.models.loader import load_model as j_load_model
from tpullama.models.testing import make_tiny_llama_gguf
from tpullama.tools import gguf_split as j_split
from tpullama_torch.gguf import GGUFReader, fulfill_split_future
from tpullama_torch.gguf import stream as t_stream
from tpullama_torch.models import loader as t_loader
from tpullama_torch.tools import gguf_split as t_split


@pytest.fixture(params=["port", "jax"])
def registry(request):
    mod = t_stream if request.param == "port" else j_stream
    return mod.SplitFutureRegistry()


def test_fulfill_before_register(registry):
    registry.fulfill("a", "ctx", b"early")
    assert registry.register("a", "ctx").extract(timeout=1) == b"early"


def test_fulfill_after_register_from_a_thread(registry):
    fut = registry.register("a", "ctx")
    th = threading.Thread(target=lambda: (time.sleep(0.05), registry.fulfill("a", "ctx", b"late")))
    th.start()
    assert fut.extract(timeout=5) == b"late"
    th.join()


def test_contexts_are_separate(registry):
    registry.fulfill("a", "one", b"1")
    registry.fulfill("a", "two", b"2")
    assert registry.register("a", "two").extract(timeout=1) == b"2"
    assert registry.register("a", "one").extract(timeout=1) == b"1"


def test_cancel_context(registry):
    fut = registry.register("a", "ctx")
    other = registry.register("a", "kept")
    registry.cancel_context("ctx")
    with pytest.raises(RuntimeError, match="cancelled"):
        fut.extract(timeout=1)
    with pytest.raises(TimeoutError):
        other.extract(timeout=0.01)


def test_release_context(registry):
    registry.fulfill("a", "ctx", b"x")
    registry.release_context("ctx")
    with pytest.raises(TimeoutError, match="not fulfilled"):
        registry.register("a", "ctx").extract(timeout=0.01)


def test_timeout(registry):
    with pytest.raises(TimeoutError):
        registry.register("missing", "ctx").extract(timeout=0.01)


def test_buffer_source():
    src = t_stream.BufferSource("m", b"GGUF")
    assert (src.name, src.data) == ("m", b"GGUF")


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("split")
    p = str(d / "m.gguf")
    make_tiny_llama_gguf(p, qtype=GGMLType.Q5_K, n_embd=256, n_ff=512, n_layer=3, seed=14)
    return d, p


def test_split_tool_equals_original(model_file):
    d, p = model_file
    t_paths = t_split.split_gguf(p, str(d / "t"), max_tensors=7)
    j_paths = j_split.split_gguf(p, str(d / "j"), max_tensors=7)
    assert len(t_paths) == len(j_paths) > 1
    for a, b in zip(t_paths, j_paths):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert t_split.shard_paths_from_first(t_paths[0]) == t_paths
    n = t_split.merge_gguf(t_paths[0], str(d / "merged.gguf"))
    assert n == len(GGUFReader(p).tensors)
    assert (open(str(d / "merged.gguf"), "rb").read()
            == open(_merged_by_original(j_paths, d), "rb").read())


def _merged_by_original(paths, d):
    out = str(d / "merged_j.gguf")
    j_split.merge_gguf(paths[0], out)
    return out


def _flat(params, pre=""):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


def _assert_same(a, b):
    fa, fb = _flat(a.params), _flat(b.params)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
    assert a.quant_meta == b.quant_meta


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_split_sources_equal_whole_file(model_file, packed):
    """load_model_from_splits, a first shard's path (its siblings opened by
    name) and load_model_from_split_futures fulfilled from a second thread
    each give the whole file's parameters."""
    d, p = model_file
    paths = t_split.split_gguf(p, str(d / f"s{int(packed)}"), max_tensors=5)
    kw = dict(device="cpu", packed=packed)
    whole = t_loader.load_model(p, **kw)
    _assert_same(t_loader.load_model_from_splits(paths, **kw), whole)
    _assert_same(t_loader.load_model_from_splits([open(q, "rb").read() for q in paths], **kw),
                 whole)
    _assert_same(t_loader.load_model(paths[0], **kw), whole)

    ctx = f"test-{packed}"

    def feed():
        for q in paths:
            time.sleep(0.02)
            fulfill_split_future(q, ctx, open(q, "rb").read())

    th = threading.Thread(target=feed)
    th.start()
    fut = t_loader.load_model_from_split_futures(paths, ctx, timeout=30, **kw)
    th.join()
    _assert_same(fut, whole)
    # the context's futures are released once loaded
    assert not any(k[1] == ctx for k in t_stream.GLOBAL_REGISTRY._futures)


def test_split_futures_time_out(model_file):
    d, p = model_file
    with pytest.raises(TimeoutError):
        t_loader.load_model_from_split_futures([p], "never", timeout=0.01, device="cpu")


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_progress_fractions_equal_jax_loader(model_file, packed):
    """One tick per tensor, ending at 1.0: the JAX loader's fractions."""
    _d, p = model_file
    got, want = [], []
    t_loader.load_model(p, device="cpu", packed=packed,
                        progress_callback=lambda f: got.append(f) or True)
    j_load_model(p, packed=packed, progress_callback=lambda f: want.append(f) or True)
    assert got == want and got[-1] == 1.0
    assert np.all(np.diff(got) > 0)


@pytest.mark.parametrize("stop_at", [0.0, 0.5, 0.99])
def test_progress_callback_cancels(model_file, stop_at):
    """A callback that returns False cancels the load (InterruptedError),
    as the JAX loader does, also on a split model."""
    d, p = model_file
    paths = t_split.split_gguf(p, str(d / "c"), max_tensors=5)
    for src in (p, paths[0]):
        seen = []
        with pytest.raises(InterruptedError, match="cancelled"):
            t_loader.load_model(src, device="cpu", packed=True,
                                progress_callback=lambda f: seen.append(f) or f <= stop_at)
        assert seen and seen[-1] > stop_at
    with pytest.raises(InterruptedError):
        j_load_model(p, packed=True, progress_callback=lambda f: f <= stop_at)
