"""The port's CLI (tpullama_torch.tools.cli) held against the JAX package's
(tpullama.tools.cli) on one tiny llama GGUF: the same argv (--dtype
float32, the port with --device cpu) prints the same text, greedy and
seeded sampled, and with the speculative, grammar and JSON-schema flags.
Flags whose feature the port has not ported yet are refused by name.

Tolerance: none. The text is the decoded tokens, and both sides pick
them from f32 logits that agree to ~1e-6 (tests/test_torch_model.py), by
argmax or by the same seeded sampler chain."""

import pytest

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
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


GRAMMAR = 'root ::= [a-z]+ (" " [a-z]+)* "."'
SCHEMA = '{"type": "object", "properties": {"name": {"type": "string"}, "n": {"type": "integer"}}}'


@pytest.mark.parametrize("flag", [
    ["--model-draft", "MODEL", "--temp", "0"], ["--model-draft", "MODEL", "--seed", "42"],
    ["--grammar", GRAMMAR, "--seed", "42"],
    ["--grammar-file", "DIR/g.gbnf", "--temp", "0", "--seed", "42"],
    ["--json-schema", SCHEMA, "--seed", "42"],
    ["--json-schema-file", "DIR/s.json", "--temp", "0", "--seed", "42"]],
    ids=["model-draft", "model-draft-seeded", "grammar", "grammar-file", "json-schema",
         "json-schema-file"])
def test_cli_ported_flags_print_the_reference_text(tiny, tmp_path, capsys, flag):
    """Speculative decoding (-md: the tiny file drafts for itself) and the
    grammar and JSON-schema flags print the reference CLI's text; a
    grammar's text is accepted by the grammar. A grammar makes a sampler
    chain even at --temp 0, which draws from its seed, so every case but
    greedy drafting gives one."""
    from tpullama.tools.cli import main as j_main
    from tpullama_torch.runtime.grammar import Grammar
    from tpullama_torch.runtime.json_schema import json_schema_to_gbnf
    from tpullama_torch.tools.cli import main as t_main

    (tmp_path / "g.gbnf").write_text(GRAMMAR)
    (tmp_path / "s.json").write_text(SCHEMA)
    flag = [f.replace("MODEL", tiny).replace("DIR", str(tmp_path)) for f in flag]
    rc_j, out_j = _run(j_main, _argv(tiny, *flag), capsys)
    rc_t, out_t = _run(t_main, _argv(tiny, *flag, "--device", "cpu"), capsys)
    assert rc_j == rc_t == 0
    assert out_t.startswith(PROMPT) and len(out_t) > len(PROMPT) + 1
    assert out_t == out_j
    if "draft" not in flag[0]:
        g_text = GRAMMAR if "grammar" in flag[0] else json_schema_to_gbnf(SCHEMA)
        Grammar.from_gbnf(g_text).accept_str(out_t[len(PROMPT):].rstrip("\n"))


@pytest.mark.parametrize("flag", [
    ["--control-vector", "cv.gguf"], ["--control-vector-scaled", "cv.gguf", "0.5"],
    ["--control-vector-layer-range", "1", "2"], ["--lora", "a.gguf"],
    ["--lookup-cache-static", "s.bin"],
    ["--lookup-cache-dynamic", "d.bin"],
    ["--split-mode", "row"]], ids=lambda f: f[0].lstrip("-"))
def test_cli_refuses_unported_flags_by_name(tiny, flag):
    """Each flag of a feature not ported yet raises before the model
    loads, naming the flag and its ROADMAP.md Queue 1 item."""
    from tpullama_torch.tools.cli import main as t_main

    with pytest.raises(NotImplementedError, match=rf"{flag[0]}.*Queue 1 item"):
        t_main(_argv(tiny, *flag, "--device", "cpu"))


@pytest.mark.parametrize("cache_kind", ["rw", "ro"])
def test_cli_prompt_cache_prints_the_reference_text(tiny, tmp_path, capsys, cache_kind):
    """--prompt-cache FILE twice, the reference CLI with its own file and the
    port with another: the first run saves the context state, the second
    restores it before generating and does not save again; both runs of
    the port print the reference's text. With --prompt-cache-ro nothing is
    written. A corrupt file warns and the run goes on as without one."""
    from tpullama.tools.cli import main as j_main
    from tpullama_torch.tools.cli import main as t_main

    ro = ["--prompt-cache-ro"] if cache_kind == "ro" else []
    files = {"jax": tmp_path / "j.bin", "torch": tmp_path / "t.bin"}
    outs = {}
    for name, main, extra in (("jax", j_main, []), ("torch", t_main, ["--device", "cpu"])):
        argv = _argv(tiny, "--temp", "0", "--prompt-cache", str(files[name]), *ro, *extra)
        outs[name] = [_run(main, argv, capsys) for _ in range(2)]
        if ro:
            assert not files[name].exists()
    assert outs["torch"] == outs["jax"]
    assert all(rc == 0 for rc, _out in outs["torch"])
    if not ro:
        assert files["torch"].read_bytes()[:4] == b"TPSN"
        # the second run restored: it saw a longer context, so other text
        assert outs["torch"][0][1] != outs["torch"][1][1]
        files["torch"].write_bytes(b"NOPE")
        rc, out = _run(t_main, _argv(tiny, "--temp", "0", "--prompt-cache",
                                     str(files["torch"]), "--device", "cpu"), capsys)
        assert rc == 0 and out == outs["torch"][0][1]


def test_cli_list_devices(capsys):
    """--list-devices lists the torch.cuda devices (none on a machine
    without a card) and exits 0."""
    import torch

    from tpullama_torch.tools.cli import main as t_main

    rc, out = _run(t_main, ["--list-devices"], capsys)
    assert rc == 0 and len(out.splitlines()) == torch.cuda.device_count()
