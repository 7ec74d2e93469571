"""scripts/torch_mma_probe.py builds each body's variants from copies of the
kernel sources patched by text: every patch must still find its text in
the current sources, or the probe stops before building anything. Checked
here on the CPU, with no nvcc: the patches of every body and variant
against tpullama_torch/csrc."""

import importlib.util
from pathlib import Path

import pytest
from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)

ROOT = Path(__file__).resolve().parents[1]


def _probe():
    spec = importlib.util.spec_from_file_location("torch_mma_probe",
                                                  ROOT / "scripts" / "torch_mma_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("body", ["mma", "group", "attention", "gemv", "fused", "gathered_t",
                                  "ktiled"])
def test_probe_patches_match_the_sources(body):
    probe = _probe()
    csrc = ROOT / "tpullama_torch" / "csrc"
    assert body in probe.VARIANTS
    for name, patches in probe.VARIANTS[body].items():
        for patch in patches:
            fname, old, _new = patch if len(patch) == 3 else (probe.HEADER[body], *patch)
            assert old in (csrc / fname).read_text(), (body, name, fname, old[:60])
