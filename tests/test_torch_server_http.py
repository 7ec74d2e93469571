"""The port's HTTP server (tpullama_torch.server.http) held against the JAX
package's (tpullama.server.http): both serve() one tiny llama GGUF on
free local ports (block=False, 2 slots of 128 cells, f32 engines on the
CPU), and one scripted session goes to each. Every JSON body, SSE event
list and Prometheus counter must be equal once the request ids,
`created` stamps, timings and rates are dropped. Grammar-constrained
bodies ("grammar", "json_schema", "response_format"), /v1/embeddings and
a server with a draft model (serve(draft_model=)) answer as the JAX
package's do, and so does a slot save / erase / restore session on
servers started with a slot save path (without one, save and restore
answer the JAX package's 501). Features the port has not ported yet answer
a 501 JSON error that names them.

Tolerance: none for text. Bodies carry decoded tokens, which both sides
pick from f32 logits that agree to ~1e-6 (tests/test_torch_model.py):
greedy, and one request through the same seeded sampler chain.
Embedding values agree within 1e-5 (f32 hidden states, sums in another
order; each vector has unit norm)."""

import json
import urllib.error
import urllib.request

import pytest

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tpullama.models.testing import make_tiny_llama_gguf

CHAT = [{"role": "system", "content": "You are terse."},
        {"role": "user", "content": "Say hi"}]
# (method, path, body); bodies greedy unless they set a seed
SESSION = [
    ("GET", "/health", None),
    ("GET", "/v1/models", None),
    ("POST", "/v1/completions", {"prompt": "Once upon a time", "max_tokens": 10,
                                 "temperature": 0}),
    ("POST", "/completion", {"prompt": "Once upon", "n_predict": 6, "temperature": 0.8,
                             "seed": 42}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 8, "temperature": 0}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 8, "temperature": 0,
                                      "stream": True}),
    ("POST", "/v1/completions", {"prompt": "abc", "max_tokens": 5, "temperature": 0,
                                 "stream": True}),
    ("POST", "/tokenize", {"content": "hello world", "add_special": True}),
    ("POST", "/detokenize", {"tokens": [104, 101, 108, 108, 111]}),
    ("POST", "/apply-template", {"messages": CHAT}),
    ("POST", "/infill", {"input_prefix": "def f(", "input_suffix": "):", "n_predict": 4,
                         "temperature": 0}),
    ("POST", "/v1/messages", {"model": "m", "max_tokens": 6, "temperature": 0,
                              "messages": [{"role": "user", "content": "hi"}]}),
    ("POST", "/v1/messages/count_tokens", {"model": "m",
                                           "messages": [{"role": "user", "content": "hi"}]}),
    ("GET", "/props", None),
    ("GET", "/slots", None),
    ("POST", "/slots/1?action=erase", {}),
    ("GET", "/lora-adapters", None),
    ("GET", "/metrics", None),
    ("GET", "/no-such-route", None),
    ("POST", "/no-such-route", {}),
]
# requests for features the port has not ported yet: (path, body, name in
# the error)
REFUSED = [
    ("/rerank", {"query": "q", "documents": ["a"]}, "/rerank"),
    ("/lora-adapters", [{"id": 0, "scale": 1.0}], "LoRA"),
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": [
         {"type": "text", "text": "what is this"},
         {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}]}]},
     "image_url"),
]
# requests of the features this slice ported, once refused: (path, body)
PORTED = {
    "embeddings": ("/v1/embeddings", {"input": ["hi", "Once upon a time"]}),
    "grammar": ("/v1/chat/completions",
                {"messages": CHAT, "max_tokens": 8, "temperature": 0,
                 "grammar": 'root ::= [a-z]+ (" " [a-z]+)* "."'}),
    "json_schema": ("/v1/completions",
                    {"prompt": "a", "max_tokens": 10, "temperature": 0, "stream": True,
                     "json_schema": {"type": "object",
                                     "properties": {"n": {"type": "integer"}}}}),
    "response_format": ("/v1/chat/completions",
                        {"messages": CHAT, "max_tokens": 8, "temperature": 0,
                         "response_format": {"type": "json_object"}}),
}
DROP = {"id", "created", "timings", "model_path"}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from tpullama.models import load_model as j_load
    from tpullama.server.http import serve as j_serve
    from tpullama_torch.models import load_model as t_load
    from tpullama_torch.server.http import serve as t_serve

    p = str(tmp_path_factory.mktemp("http") / "m.gguf")
    make_tiny_llama_gguf(p, n_layer=2, seed=7)
    out = {}
    for name, load, serve, kw in (("jax", j_load, j_serve, {}),
                                  ("torch", t_load, t_serve, {"device": "cpu"})):
        httpd = serve(load(p, **kw), port=0, n_slots=2, n_ctx=128, block=False)
        out[name] = f"http://127.0.0.1:{httpd.server_address[1]}"
        out[name + "_httpd"] = httpd
    yield out
    for name in ("jax", "torch"):
        httpd = out[name + "_httpd"]
        httpd.shutdown()
        httpd.engine.stop()
        httpd.server_close()


def _request(base, method, path, body):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, ctype, raw = r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        code, ctype, raw = e.code, e.headers.get("Content-Type", ""), e.read()
    return code, ctype, raw.decode()


def _clean(obj):
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items() if k not in DROP}
    if isinstance(obj, list):
        return [_clean(v) for v in obj]
    return obj


def _parsed(ctype, text):
    """A response as comparable data: JSON without ids, stamps and timings;
    SSE as its list of events; Prometheus text without its rates."""
    if ctype.startswith("application/json"):
        return _clean(json.loads(text))
    if ctype.startswith("text/event-stream"):
        events = []
        for line in text.splitlines():
            if line.startswith("data: "):
                d = line[6:]
                events.append(d if d == "[DONE]" else _clean(json.loads(d)))
            elif line.startswith("event: "):
                events.append(line)
        return events
    return [ln for ln in text.splitlines() if "_seconds" not in ln]


def test_session_bodies_equal_the_reference(servers):
    """Each request of the script goes to both servers in turn: same status
    and content type, and equal bodies."""
    for m, path, body in SESSION:
        code_j, ctype_j, text_j = _request(servers["jax"], m, path, body)
        code_t, ctype_t, text_t = _request(servers["torch"], m, path, body)
        assert (code_t, ctype_t) == (code_j, ctype_j), (m, path)
        assert _parsed(ctype_t, text_t) == _parsed(ctype_j, text_j), (m, path)


def test_streamed_chat_concatenates_to_the_plain_text(servers):
    body = {"messages": CHAT, "max_tokens": 8, "temperature": 0}
    _, _, plain = _request(servers["torch"], "POST", "/v1/chat/completions", body)
    _, _, stream = _request(servers["torch"], "POST", "/v1/chat/completions",
                            {**body, "stream": True})
    events = _parsed("text/event-stream", stream)
    assert events[-1] == "[DONE]"
    text = "".join(e["choices"][0]["delta"].get("content", "") for e in events[:-1])
    assert text == json.loads(plain)["choices"][0]["message"]["content"]


def _close(a, b):
    """Equal data, floats within 1e-5."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_close, a, b))
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= 1e-5
    return a == b


@pytest.mark.parametrize("case", sorted(PORTED))
def test_ported_bodies_equal_the_reference(servers, case):
    """Grammar-constrained completions give the reference's text (which the
    grammar accepts), and /v1/embeddings its vectors."""
    path, body = PORTED[case]
    code_j, ctype_j, text_j = _request(servers["jax"], "POST", path, body)
    code_t, ctype_t, text_t = _request(servers["torch"], "POST", path, body)
    assert (code_t, ctype_t) == (code_j, ctype_j) == (200, ctype_j)
    assert _close(_parsed(ctype_t, text_t), _parsed(ctype_j, text_j))
    parsed = _parsed(ctype_t, text_t)
    if case == "embeddings":
        data = parsed["data"]
        assert len(data) == 2 and all(abs(sum(x * x for x in d["embedding"]) - 1) < 1e-5
                                      for d in data)
        return
    from tpullama_torch.server.http import _make_grammar

    if ctype_t.startswith("text/event-stream"):
        text = "".join(e["choices"][0]["text"] for e in parsed if isinstance(e, dict))
    else:
        text = parsed["choices"][0]["message"]["content"]
    assert text
    _make_grammar(body, None).accept_str(text)  # raises on a refused character


@pytest.mark.parametrize("action", ["save", "restore"])
def test_slot_action_without_save_path_answers_the_reference(servers, action):
    """Without a slot save path both servers refuse save and restore with
    the same 501 body."""
    path, body = f"/slots/0?action={action}", {"filename": "s.bin"}
    got = {k: _request(servers[k], "POST", path, body) for k in ("jax", "torch")}
    assert got["torch"] == got["jax"] and got["torch"][0] == 501


SLOT_SESSION = [
    ("POST", "/completion", {"prompt": "Once upon a time", "n_predict": 8, "temperature": 0}),
    ("POST", "/slots/0?action=save", {"filename": "slot0.bin"}),
    ("POST", "/slots/0?action=erase", {}),
    ("GET", "/slots", None),
    ("POST", "/slots/0?action=restore", {"filename": "slot0.bin"}),
    ("GET", "/slots", None),
    ("POST", "/completion", {"prompt": "Once upon a time", "n_predict": 8, "temperature": 0}),
    ("POST", "/slots/1?action=restore", {"filename": "slot0.bin"}),
    ("POST", "/completion", {"prompt": "Once upon a time, far", "n_predict": 6,
                             "temperature": 0}),
    ("POST", "/slots/0?action=save", {"filename": "../escape.bin"}),
    ("POST", "/slots/0?action=save", {}),
    ("POST", "/slots/9?action=save", {"filename": "x.bin"}),
]


def test_slot_save_restore_session_equals_the_reference(tmp_path):
    """Both servers with a slot save path of their own: a completion, save
    slot 0, erase it, restore it (n_restored equal to n_saved), and the
    same completion again gives the same text; a restore into another
    slot; refused file names and slot ids. Equal statuses and bodies
    (timings dropped); a missing file fails on both with a 400."""
    from tpullama.models import load_model as j_load
    from tpullama.server.http import serve as j_serve
    from tpullama_torch.models import load_model as t_load
    from tpullama_torch.server.http import serve as t_serve

    p = str(tmp_path / "m.gguf")
    make_tiny_llama_gguf(p, n_layer=2, seed=7)
    bases, httpds = {}, []
    try:
        for name, load, serve, kw in (("jax", j_load, j_serve, {}),
                                      ("torch", t_load, t_serve, {"device": "cpu"})):
            d = tmp_path / name
            d.mkdir()
            httpd = serve(load(p, **kw), port=0, n_slots=2, n_ctx=128, block=False,
                          slot_save_path=str(d))
            httpds.append(httpd)
            bases[name] = f"http://127.0.0.1:{httpd.server_address[1]}"
        bodies = []
        for m, path, body in SLOT_SESSION:
            got = {k: _request(b, m, path, body) for k, b in bases.items()}
            assert got["torch"][:2] == got["jax"][:2], path
            assert _parsed(*got["torch"][1:]) == _parsed(*got["jax"][1:]), path
            bodies.append(json.loads(got["torch"][2]))
        assert (tmp_path / "torch" / "slot0.bin").read_bytes()[:4] == b"TPSQ"
        assert bodies[1]["n_saved"] == bodies[4]["n_restored"] > 0
        assert bodies[1]["filename"] == "slot0.bin" and "save_ms" in bodies[1]["timings"]
        assert bodies[6]["content"] == bodies[0]["content"]
        codes = {k: _request(b, "POST", "/slots/0?action=restore",
                             {"filename": "missing.bin"})[0] for k, b in bases.items()}
        assert codes == {"jax": 400, "torch": 400}
    finally:
        for httpd in httpds:
            httpd.shutdown()
            httpd.engine.stop()
            httpd.server_close()


@pytest.mark.parametrize("path,body,name", REFUSED, ids=[r[2] for r in REFUSED])
def test_unported_features_answer_an_error_naming_them(servers, path, body, name):
    code, ctype, text = _request(servers["torch"], "POST", path, body)
    err = json.loads(text)["error"]
    assert code == 501 and ctype.startswith("application/json")
    assert err["type"] == "not_supported_error"
    assert name in err["message"] and "Queue 1 item" in err["message"]
    # the handler lives on: the server still answers
    assert _request(servers["torch"], "GET", "/health", None)[0] == 200


@pytest.mark.parametrize("kw,name", [
    (dict(mmproj="p.gguf"), "mmproj"), (dict(loras=[("a.gguf", 1.0)]), "loras"),
    (dict(kv_unified=True), "kv_unified"),
    (dict(split_mode="row"), "split_mode")], ids=lambda v: v if isinstance(v, str) else "")
def test_serve_refuses_unported_options_by_name(kw, name):
    from tpullama_torch.server.http import serve

    with pytest.raises(NotImplementedError, match=rf"{name}.*Queue 1 item"):
        serve(None, port=0, block=False, **kw)


def test_served_spec_session_equals_the_reference(tmp_path):
    """Both servers with a draft model (the target file drafting for itself,
    4 drafts a round, no confidence gate): the same completions, and the
    same draft counters on /metrics."""
    from tpullama.models import load_model as j_load
    from tpullama.runtime.speculative import SpeculativeParams as JSP
    from tpullama.server.http import serve as j_serve
    from tpullama_torch.models import load_model as t_load
    from tpullama_torch.runtime.speculative import SpeculativeParams as TSP
    from tpullama_torch.server.http import serve as t_serve

    p = str(tmp_path / "m.gguf")
    make_tiny_llama_gguf(p, n_layer=2, seed=7)
    bases, httpds = {}, []
    try:
        for name, load, serve, sp, kw in (("jax", j_load, j_serve, JSP, {}),
                                          ("torch", t_load, t_serve, TSP, {"device": "cpu"})):
            httpd = serve(load(p, **kw), port=0, n_slots=2, n_ctx=128, block=False,
                          draft_model=load(p, **kw), spec_params=sp(n_draft=4, p_min=0.0))
            httpds.append(httpd)
            bases[name] = f"http://127.0.0.1:{httpd.server_address[1]}"
        script = [("POST", "/v1/completions", {"prompt": "Once upon a time", "max_tokens": 12,
                                               "temperature": 0}),
                  ("POST", "/completion", {"prompt": "abc", "n_predict": 6, "temperature": 0,
                                           "stream": True}),
                  ("GET", "/metrics", None)]
        for m, path, body in script:
            got = {k: _request(b, m, path, body) for k, b in bases.items()}
            assert got["torch"][:2] == got["jax"][:2] and got["torch"][0] == 200
            assert _parsed(*got["torch"][1:]) == _parsed(*got["jax"][1:]), path
        metrics = got["torch"][2]
        assert "llamacpp:draft_tokens_total" in metrics
        drafted = int(next(ln.split()[1] for ln in metrics.splitlines()
                           if ln.startswith("llamacpp:draft_tokens_total")))
        assert drafted > 0
    finally:
        for httpd in httpds:
            httpd.shutdown()
            httpd.engine.stop()
            httpd.server_close()
