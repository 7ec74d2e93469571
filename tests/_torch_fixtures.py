"""Fixture helpers of the port's test files (not a test module).

`tiny_gguf` writes a tpullama.models.testing.make_tiny_llama_gguf file
once per test run and hands every later caller, in any file and any
xdist worker of the run, the same path: the files live in the run's
directory (the parent of the worker's basetemp under xdist, the basetemp
itself in one process), named by a hash of the writer's arguments, each
written under a file lock and moved into place whole.

Importing this module sets PyTorch to one intra-op thread for the test
process: the port's CPU tests run tiny tensors, and under xdist's workers
each of PyTorch's default thread pools (one thread per core) spins
against the others' (a file of MoE cases took 353 s of CPU with 8
threads a process and 38 s with 1). Every tests/test_torch_*.py file
imports it.

`quick_seqsum` swaps, while a fixture writes, the K-quant quantizer's
sequential f32 column sum (tpullama.gguf.quants._seqsum_f32, a Python
loop over columns) for one np.cumsum, which adds the same terms in the
same left-to-right order in f32, so every byte written is the same
(tests/test_torch_fixtures.py holds the two sums and the quantized
blocks equal). The quantizer's code is not changed; its 4096-wide Q4_K
fixtures spend about half their time in that loop."""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os

import numpy as np
import torch

torch.set_num_threads(1)


def seqsum_cumsum(a: np.ndarray) -> np.ndarray:
    """_seqsum_f32 of an f32 array: the running sum of np.cumsum (the
    same additions in the same order), plus +0.0 so that a row of zeros
    sums to +0.0 as the loop's zero start makes it."""
    return np.cumsum(a, axis=1, dtype=np.float32)[:, -1] + np.float32(0.0)


@contextlib.contextmanager
def quick_seqsum():
    """tpullama.gguf.quants._seqsum_f32 as seqsum_cumsum for f32 input
    (any other dtype keeps the loop) while the block runs."""
    from tpullama.gguf import quants

    loop = quants._seqsum_f32

    def seqsum(a):
        return seqsum_cumsum(a) if a.dtype == np.float32 and a.ndim == 2 else loop(a)

    quants._seqsum_f32 = seqsum
    try:
        yield
    finally:
        quants._seqsum_f32 = loop


def run_dir(tmp_path_factory) -> str:
    """The directory every worker of this test run shares."""
    base = tmp_path_factory.getbasetemp()
    return str(base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base)


def _key(kw: dict) -> str:
    def plain(v):
        return getattr(v, "name", v)

    return json.dumps({k: plain(v) for k, v in sorted(kw.items())}, sort_keys=True)


def cached_file(tmp_path_factory, tag: str, kw: dict, write) -> str:
    """The path of the run's file for (tag, kw): write(path) runs once per
    run, under a lock, into a temporary name moved into place after."""
    d = os.path.join(run_dir(tmp_path_factory), "gguf-cache")
    os.makedirs(d, exist_ok=True)
    name = hashlib.sha1(f"{tag}:{_key(kw)}".encode()).hexdigest()[:20]
    path = os.path.join(d, name + ".gguf")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                tmp = f"{path}.{os.getpid()}.part"
                with quick_seqsum():
                    write(tmp)
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def tiny_gguf(tmp_path_factory, **kw) -> str:
    """make_tiny_llama_gguf(path, **kw), written once per test run."""
    from tpullama.models.testing import make_tiny_llama_gguf

    return cached_file(tmp_path_factory, "make_tiny_llama_gguf", kw,
                       lambda p: make_tiny_llama_gguf(p, **kw))
