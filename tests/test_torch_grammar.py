"""The port's copies of the GBNF engine and the JSON-schema converter
(tpullama_torch/runtime/grammar.py, json_schema.py) held against the JAX
package's originals: the JAX package's tests/test_grammar.py and
tests/test_json_schema.py cases, each run on both copies; the GBNF text a
schema converts to, and the parsed rules, identical; the token ids the
grammar masks over a tiny byte-level vocab identical, step after step;
then the grammar-constrained paths of the port's CLI flags
(tools/args.sampler_from_args) and engine (ServerEngine._sample) on a
tiny llama, against the JAX package's.

Tolerance: none. The copies run the same code, so strings, rule lists,
masked id sets and decoded tokens must be equal (tokens are picked by
argmax of f32 logits that agree to ~1e-6, tests/test_torch_model.py)."""

import numpy as np
import pytest

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tpullama.models.testing import make_tiny_llama_gguf
from tpullama.runtime import grammar as j_grammar
from tpullama.runtime import json_schema as j_schema
from tpullama.runtime import sampling as j_sampling
from tpullama_torch.runtime import grammar as t_grammar
from tpullama_torch.runtime import json_schema as t_schema
from tpullama_torch.runtime import sampling as t_sampling

PKGS = {"jax": (j_grammar, j_schema, j_sampling), "torch": (t_grammar, t_schema, t_sampling)}

# test_grammar.py: (grammar, accepted, rejected)
GRAMMARS = {
    "sequence": ('root ::= "ab" "c"', ["abc"], ["ab", "abcd", "abd"]),
    "alternates": ('root ::= "cat" | "dog"', ["cat", "dog"], ["cow"]),
    "ranges": ("root ::= [a-z]+", ["hello"], ["Hello", ""]),
    "negated": ("root ::= [^a-z]+", ["123!"], ["a"]),
    "star": ('root ::= "a"*', ["", "aaaa"], []),
    "plus": ('root ::= "a"+', ["a"], [""]),
    "optional": ('root ::= "a"?', ["", "a"], ["aa"]),
    "bounded": ('root ::= "a"{2,4}', ["aa", "aaaa"], ["a", "aaaaa"]),
    "exact": ("root ::= [0-9]{3}", ["123"], ["12", "1234"]),
    "nested": ('root ::= expr\nexpr ::= term ("+" term)*\nterm ::= [0-9]+',
               ["1+2+3", "42"], ["1+", "+1"]),
    "grouping": ('root ::= ("a" | "b") "c"', ["ac", "bc"], ["abc"]),
    "dot": ('root ::= "x" . "y"', ["xay", "x†y"], ["xy"]),
    "utf8": ("root ::= [α-ω]+", ["αβγ"], ["abc"]),
    "escapes": (r'root ::= "\"" [^"]* "\""', ['"hello"'], ['"hello']),
    "words": ('root ::= word (" " word)* "."\nword ::= "the" | "a" | "model" | "card"',
              ["the model.", "a card the card."], ["the", "model the"]),
}
BAD_GRAMMARS = {"undefined": "root ::= missing", "left_recursion": 'root ::= root "a" | "b"',
                "no_root": 'start ::= "a"'}
# test_json_schema.py: (schema, valid, invalid)
SCHEMAS = {
    "boolean": ({"type": "boolean"}, ["true", "false"], ["1", '"true"']),
    "integer": ({"type": "integer"}, ["0", "42", "-7"], ["1.5", "abc", "+1", "007"]),
    "number": ({"type": "number"}, ["0", "3.25", "-1e3", "2E-2"], ['"x"', "--1"]),
    "string": ({"type": "string"}, ['"hi"', '""', '"a\\nb"', '"\\u0041"'],
               ["hi", '"unterminated']),
    "string_length": ({"type": "string", "minLength": 2, "maxLength": 3},
                      ['"ab"', '"abc"'], ['"a"', '"abcd"']),
    "enum": ({"enum": ["red", "green", 3]}, ['"red"', '"green"', "3"], ['"blue"', "4"]),
    "const": ({"const": {"a": 1}}, ['{"a": 1}'], ['{"a": 2}']),
    "object": ({"type": "object", "properties": {"name": {"type": "string"},
                                                 "age": {"type": "integer"}},
                "required": ["name", "age"], "additionalProperties": False},
               ['{"name": "x", "age": 3}'], ['{"name": "x"}', '{"age": 3, "name": "x"}']),
    "prefix_items": ({"prefixItems": [{"type": "integer"}, {"type": "string"}]},
                     ['[1, "a"]'], ["[1]", '["a", 1]']),
    "anyof": ({"anyOf": [{"type": "integer"}, {"type": "string"}]}, ["5", '"five"'], ["true"]),
    "refs": ({"$defs": {"pos": {"type": "integer"}}, "type": "object",
              "properties": {"x": {"$ref": "#/$defs/pos"}}, "required": ["x"],
              "additionalProperties": False}, ['{"x": 5}'], ['{"x": "a"}']),
    "date": ({"type": "string", "format": "date"}, ['"2024-01-31"'],
             ['"2024-1-31"', '"20240131"']),
    "untyped": ({}, ["1", '"x"', "[1, 2]", '{"a": null}'], ["nope"]),
    "json_object": ({"type": "object"}, ['{}', '{"a": [1, "b"]}'], ["[1]"]),
}


def _accepts(grammar_mod, g_text: str, s: str) -> bool:
    g = grammar_mod.Grammar.from_gbnf(g_text)
    try:
        g.accept_str(s)
    except ValueError:
        return False
    return any(not st for st in g.stacks)


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", sorted(GRAMMARS))
def test_grammar_accepts_and_rejects(case, pkg):
    gm = PKGS[pkg][0]
    g_text, good, bad = GRAMMARS[case]
    assert all(_accepts(gm, g_text, s) for s in good)
    assert not any(_accepts(gm, g_text, s) for s in bad)


@pytest.mark.parametrize("case", sorted(GRAMMARS))
def test_parsed_rules_are_identical(case):
    g_text = GRAMMARS[case][0]
    pj, pt = j_grammar.GBNFParser(), t_grammar.GBNFParser()
    assert pt.parse(g_text) == pj.parse(g_text)
    assert pt.symbol_ids == pj.symbol_ids


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", sorted(BAD_GRAMMARS))
def test_parse_errors(case, pkg):
    with pytest.raises(PKGS[pkg][0].GrammarParseError):
        PKGS[pkg][0].Grammar.from_gbnf(BAD_GRAMMARS[case])


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", sorted(SCHEMAS))
def test_schema_grammar_accepts_and_rejects(case, pkg):
    gm, sm, _ = PKGS[pkg]
    schema, good, bad = SCHEMAS[case]
    g_text = sm.json_schema_to_gbnf(schema)
    assert all(_accepts(gm, g_text, s) for s in good), g_text
    assert not any(_accepts(gm, g_text, s) for s in bad), g_text


@pytest.mark.parametrize("case", sorted(SCHEMAS))
def test_schema_gbnf_is_identical(case):
    schema = SCHEMAS[case][0]
    assert t_schema.json_schema_to_gbnf(schema) == j_schema.json_schema_to_gbnf(schema)
    # a schema given as JSON text converts the same
    import json

    assert (t_schema.json_schema_to_gbnf(json.dumps(schema))
            == j_schema.json_schema_to_gbnf(json.dumps(schema)))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tpullama.models import load_model as j_load
    from tpullama_torch.models import load_model as t_load

    p = str(tmp_path_factory.mktemp("grammar") / "m.gguf")
    make_tiny_llama_gguf(p, n_layer=2, seed=13)
    return {"jax": j_load(p), "torch": t_load(p, device="cpu"), "path": p}


MASK_CASES = {
    "words": (GRAMMARS["words"][0], "the model the card."),
    "digits": ("root ::= [0-9]{3}", "123"),
    "schema": (j_schema.json_schema_to_gbnf(SCHEMAS["object"][0]), '{"name": "é", "age": 7}'),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_masked_ids_are_identical(tiny, case):
    """Over the tiny byte-level vocab, the ids each copy masks (-inf) before
    every accepted byte token of a conforming text are the same set, and
    the end of generation is allowed only once the text is complete."""
    g_text, text = MASK_CASES[case]
    gs = {k: PKGS[k][0].Grammar.from_gbnf(g_text, vocab=tiny[k].vocab) for k in PKGS}
    n_vocab = tiny["torch"].hparams.n_vocab
    toks = [3 + b for b in text.encode("utf-8")]  # <0xNN> byte tokens
    eos = tiny["torch"].vocab.eos_id
    for i in range(len(toks) + 1):
        masked = {}
        for k, g in gs.items():
            cur = PKGS[k][2].Candidates.from_logits(np.zeros(n_vocab, np.float32))
            g.apply(cur)
            masked[k] = set(cur.ids[np.isneginf(cur.logits)].tolist())
        assert masked["torch"] == masked["jax"]
        assert (eos in masked["torch"]) == (i < len(toks))
        if i < len(toks):
            assert toks[i] not in masked["torch"]
            for g in gs.values():
                g.accept(toks[i])


def test_constrained_generation(tiny):
    """The JAX package's end-to-end case on the port: grammar-masked greedy
    sampling emits three digits, the JAX package's tokens."""
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP

    outs = {}
    for k, ctx_cls, cp in (("jax", JC, JCP), ("torch", TC, TCP)):
        gm, _, sampling = PKGS[k]
        m = tiny[k]
        ctx = ctx_cls(m, cp(n_ctx=64))
        gs = gm.GrammarSampler(gm.Grammar.from_gbnf("root ::= [0-9]{3}", vocab=m.vocab))
        logits = ctx.decode(np.asarray(m.vocab.tokenize("x", add_special=True), np.int32))[-1]
        out = []
        for _ in range(5):
            cur = sampling.Candidates.from_logits(logits)
            gs.apply(cur)
            tok = int(cur.ids[int(np.argmax(cur.logits))])
            if m.vocab.is_eog(tok):
                break
            gs.accept(tok)
            out.append(tok)
            logits = ctx.decode(np.asarray([tok], np.int32))[-1]
        outs[k] = out
    text = bytes(t - 3 for t in outs["torch"] if 3 <= t < 259).decode()
    assert len(text) == 3 and text.isdigit(), text
    assert outs["torch"] == outs["jax"]


@pytest.mark.parametrize("flags", [
    ["--grammar", 'root ::= [a-z]+ " " [0-9]+'],
    ["--json-schema", '{"type": "object", "properties": {"n": {"type": "integer"}}}'],
    ["--grammar", 'root ::= ("ab" | "c")+', "--temp", "0.8", "--seed", "3"]],
    ids=["grammar", "json_schema", "sampled"])
def test_sampler_from_args_chain_is_the_reference(tiny, flags):
    """sampler_from_args builds the reference's chain: greedy turns into a
    chain when a grammar is given, with the grammar after the logit-shaping
    samplers, and both chains pick the same tokens on the same logits."""
    from tpullama.tools import args as j_args
    from tpullama_torch.tools import args as t_args

    chains = {}
    for k, mod in (("jax", j_args), ("torch", t_args)):
        a = mod.build_parser("cli", "cli").parse_args(["-m", "m.gguf", "--temp", "0", *flags])
        chains[k] = mod.sampler_from_args(a, vocab=tiny[k].vocab,
                                          n_vocab=tiny[k].hparams.n_vocab)
    names = {k: [getattr(s, "name", type(s).__name__) for s in c.samplers]
             for k, c in chains.items()}
    assert names["torch"] == names["jax"] and "grammar" in names["torch"]
    rng = np.random.default_rng(0)
    for _ in range(6):
        logits = rng.standard_normal(tiny["torch"].hparams.n_vocab).astype(np.float32)
        toks = [c.sample(logits.copy()) for c in (chains["jax"], chains["torch"])]
        assert toks[1] == toks[0]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_engine_grammar_completion_is_the_reference(tiny, sampled):
    """ServerEngine.complete(grammar=) on both packages: a grammar slot
    masks each step's logits, samples (argmax or the seeded chain) and
    advances the grammar; the same tokens and text, accepted by the
    grammar. The grammar also keeps the slot out of the greedy burst."""
    from tpullama.server.engine import ServerEngine as JE
    from tpullama_torch.server.engine import ServerEngine as TE

    g_text = GRAMMARS["words"][0]
    outs = {}
    for k, eng_cls in (("jax", JE), ("torch", TE)):
        gm, _, sampling = PKGS[k]
        eng = eng_cls(tiny[k], n_slots=2, n_ctx=64)
        sampler = sampling.SamplerChain.from_params(seed=5, temp=0.9) if sampled else None
        task = eng.complete("Once", n_predict=12, sampler=sampler,
                            grammar=gm.Grammar.from_gbnf(g_text, vocab=tiny[k].vocab))
        assert not task.error
        outs[k] = (task.out_tokens, task.out_text)
    assert outs["torch"] == outs["jax"]
    g = t_grammar.Grammar.from_gbnf(g_text)
    g.accept_str(outs["torch"][1])  # raises on a character the grammar refuses
