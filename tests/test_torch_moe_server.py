"""The ServerEngine scripts of the MoE arch files (tests/test_torch_model.py's
script on the packed qwen3moe model of tests/test_torch_moe_archs.py and on
the heterogeneous stacks of tests/test_torch_hetero_moe.py), moved whole
into a file of their own so that no one file sets tier-1's wall: the same
completions, stop reasons and metrics as the JAX engine."""

import pytest

# the fixtures of the two arch files (the run's cached files)
from tests.test_torch_hetero_moe import ARCHS, hetero_ggufs  # noqa: F401
from tests.test_torch_model import _check_server_script
from tests.test_torch_moe_archs import moe_arch_ggufs  # noqa: F401
from tpullama.gguf import GGMLType


def test_qwen3moe_server_engine_script(moe_arch_ggufs):
    """test_server_engine_script on the packed qwen3moe model."""
    _check_server_script(moe_arch_ggufs["qwen3moe", GGMLType.Q4_K])


@pytest.mark.parametrize("arch", ARCHS)
def test_hetero_server_engine_script(hetero_ggufs, arch):
    """tests/test_torch_model.py's ServerEngine script on the packed model:
    the same completions, stop reasons and metrics as the JAX engine."""
    _check_server_script(hetero_ggufs[arch, GGMLType.Q4_K])
