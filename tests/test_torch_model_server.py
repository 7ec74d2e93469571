"""The ServerEngine scripts of tests/test_torch_model.py on its packed
Q4_K llama and Mixtral-style MoE fixtures, moved whole into a file of
their own so that no one file sets tier-1's wall: concurrent greedy and
sampled requests with prompt chunks, a stop string, a prompt-cache reuse,
a too-long prompt and a burst-decoded tail, with the same completions,
stop reasons and metrics as the JAX engine."""

# the fixtures of tests/test_torch_model.py (the run's cached files)
from tests.test_torch_model import _check_server_script, ggufs, moe_gguf  # noqa: F401
from tpullama.gguf import GGMLType


def test_server_engine_script(ggufs):
    """Concurrent greedy and sampled requests with prompt chunks, a stop
    string, a prompt-cache reuse, a too-long prompt and a burst-decoded
    tail: the same completions and stop reasons as the JAX engine."""
    _check_server_script(ggufs[GGMLType.Q4_K])


def test_moe_server_engine_script(moe_gguf):
    """test_server_engine_script on the MoE model."""
    _check_server_script(moe_gguf)
