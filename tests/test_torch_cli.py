"""The port's CLI (tpullama_torch.tools.cli) held against the JAX package's
(tpullama.tools.cli) on one tiny llama GGUF: the same argv (--dtype
float32, the port with --device cpu) prints the same text, greedy and
seeded sampled. Flags whose feature the port has not ported yet are
refused by name.

Tolerance: none. The text is the decoded tokens, and both sides pick
them from f32 logits that agree to ~1e-6 (tests/test_torch_model.py), by
argmax or by the same seeded sampler chain."""

import pytest

from tpullama.models.testing import make_tiny_llama_gguf

PROMPT = "Once upon a time"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("cli") / "m.gguf")
    make_tiny_llama_gguf(p, n_layer=2, seed=3)
    return p


def _argv(path, *extra):
    return ["-m", path, "-p", PROMPT, "-n", "12", "--dtype", "float32", "-c", "128", *extra]


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("sampling", [["--temp", "0"], ["--temp", "0.8", "--seed", "42"]],
                         ids=["greedy", "seeded"])
def test_cli_prints_the_reference_text(tiny, capsys, sampling):
    from tpullama.tools.cli import main as j_main
    from tpullama_torch.tools.cli import main as t_main

    rc_j, out_j = _run(j_main, _argv(tiny, *sampling), capsys)
    rc_t, out_t = _run(t_main, _argv(tiny, *sampling, "--device", "cpu"), capsys)
    assert rc_j == rc_t == 0
    assert out_t.startswith(PROMPT) and len(out_t) > len(PROMPT) + 1
    assert out_t == out_j


@pytest.mark.parametrize("burst", ["1", "4", "16"])
def test_cli_burst_prints_the_reference_text(tiny, capsys, burst):
    """Greedy decoding in on-device chunks of --burst tokens (the reference
    CLI's generate(burst=)) prints the reference's text at each width."""
    from tpullama.tools.cli import main as j_main
    from tpullama_torch.tools.cli import main as t_main

    argv = _argv(tiny, "--temp", "0", "--burst", burst)
    rc_j, out_j = _run(j_main, argv, capsys)
    rc_t, out_t = _run(t_main, argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert out_t.startswith(PROMPT) and len(out_t) > len(PROMPT) + 1
    assert out_t == out_j


@pytest.mark.parametrize("flag", [
    ["--control-vector", "cv.gguf"], ["--control-vector-scaled", "cv.gguf", "0.5"],
    ["--control-vector-layer-range", "1", "2"], ["--lora", "a.gguf"],
    ["--model-draft", "d.gguf"], ["--lookup-cache-static", "s.bin"],
    ["--lookup-cache-dynamic", "d.bin"], ["--prompt-cache", "p.bin"],
    ["--grammar", 'root ::= "a"'], ["--grammar-file", "g.gbnf"],
    ["--json-schema", "{}"], ["--json-schema-file", "s.json"],
    ["--split-mode", "row"]], ids=lambda f: f[0].lstrip("-"))
def test_cli_refuses_unported_flags_by_name(tiny, flag):
    """Each flag of a feature not ported yet raises before the model
    loads, naming the flag and its ROADMAP.md Queue 1 item."""
    from tpullama_torch.tools.cli import main as t_main

    with pytest.raises(NotImplementedError, match=rf"{flag[0]}.*Queue 1 item"):
        t_main(_argv(tiny, *flag, "--device", "cpu"))


def test_cli_list_devices(capsys):
    """--list-devices lists the torch.cuda devices (none on a machine
    without a card) and exits 0."""
    import torch

    from tpullama_torch.tools.cli import main as t_main

    rc, out = _run(t_main, ["--list-devices"], capsys)
    assert rc == 0 and len(out.splitlines()) == torch.cuda.device_count()
