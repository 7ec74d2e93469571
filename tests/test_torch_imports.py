"""The PyTorch port (tpullama_torch) stands alone: no file of it, nor
chip_smoke.py, imports jax or the JAX package; importing it leaves jax
out of sys.modules; its entry points run on the CUDA card unless the
caller passes device="cpu", and raise without one; its kernel wrappers
take the plain version only for CPU tensors."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tpullama_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "tpullama"), f"{path.name} imports {name}"


def test_import_leaves_jax_out():
    mods = [p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
            .removesuffix(".__init__") for p in PORT_FILES]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpullama'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA card")


def test_entry_points_default_to_cuda(tmp_path, no_cuda):
    from tpullama.gguf import GGMLType
    from tpullama.models.testing import make_tiny_llama_gguf
    from tpullama_torch.device import resolve_device
    from tpullama_torch.models import load_model, params_from_numpy

    path = str(tmp_path / "m.gguf")
    make_tiny_llama_gguf(path, qtype=GGMLType.F32)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(path)
    cpu = load_model(path, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({}, None, cpu.hparams)
    assert cpu.device == torch.device("cpu")
    assert cpu.params["tok_embd"].device.type == "cpu"


def test_wrappers_raise_off_cpu():
    """A tensor neither on the CPU nor on a CUDA card is refused: the plain
    version is taken for CPU tensors only."""
    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.cuda.flash_attention import flash_attention
    from tpullama_torch.ops.cuda.flash_decode import flash_decode
    from tpullama_torch.ops.cuda.qmm import quantized_matmul

    x = torch.zeros((1, 512), device="meta")
    fields = {"q4": torch.zeros((8, 256), dtype=torch.uint8, device="meta"),
              "scale": torch.zeros((8, 16), device="meta"),
              "minv": torch.zeros((8, 16), device="meta")}
    with pytest.raises(RuntimeError, match="device"):
        quantized_matmul(x, fields, GGMLType.Q4_K, 32, 8, 512)
    q = torch.zeros((1, 1, 4, 64), device="meta")
    kv = torch.zeros((1, 2, 128, 64), device="meta")
    mask = torch.zeros((1, 1, 1, 128), device="meta")
    for fn in (flash_attention, flash_decode):
        with pytest.raises(RuntimeError, match="device"):
            fn(q, kv, kv, mask, 0.125)


def test_cpu_tensors_take_plain_versions():
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch."""
    from tpullama_torch.ops.cuda import launch_counts, reset_launch_counts
    from tpullama_torch.ops.cuda.common import flash_plain
    from tpullama_torch.ops.cuda.flash_attention import flash_attention
    from tpullama_torch.ops.cuda.flash_decode import flash_decode

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 128, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 128, 64)).astype(np.float32))
    mask = torch.zeros((1, 1, 2, 128))
    reset_launch_counts()
    want = flash_plain(q, k, v, mask, 0.125)
    for fn in (flash_attention, flash_decode):
        torch.testing.assert_close(fn(q, k, v, mask, 0.125), want, rtol=0, atol=0)
    assert not any(launch_counts().values())
