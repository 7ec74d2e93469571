"""HTTP server: OpenAI-compatible + llama.cpp-native endpoints (port of
tpullama/server/http.py over the port's ServerEngine).

Routes mirror tools/server/server.cpp:149-187:
  GET  /health /props /metrics /slots /v1/models
  POST /completion /v1/completions /v1/chat/completions
  POST /tokenize /detokenize /apply-template

Streaming uses SSE (data: {...}\n\n, terminated by data: [DONE]).
Chat templating: the GGUF's tokenizer.chat_template rendered with jinja2
(the role minja plays in the reference), with a ChatML fallback.

Grammar-constrained bodies ("grammar", "json_schema", a JSON
"response_format"), /embedding(s), serve(draft_model=) / --model-draft and
POST /slots/{id}?action=save|restore|erase (save and restore under
--slot-save-path) run as in the JAX package. Features not ported yet
answer a JSON error (501, not_supported_error) that names them and their
ROADMAP.md Queue 1 item, and serve() / main() refuse their options by
name: LoRA adapters, the unified KV pool (item 6); /rerank, which
needs the rank-pooled encoder path (item 7); media in chat and --mmproj
(item 8); --split-mode other than none (item 10).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..runtime.sampling import SamplerChain
from .engine import ServerEngine, Task

CHATML_FALLBACK = (
    "{% for message in messages %}<|im_start|>{{ message.role }}\n"
    "{{ message.content }}<|im_end|>\n{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)


def apply_chat_template(model, messages: list, add_generation_prompt: bool = True,
                        tools: list | None = None,
                        template_override: str | None = None) -> str:
    """Render the chat prompt. Resolution order mirrors the reference
    server: an explicit --chat-template NAME uses the builtin dialect
    (src/llama-chat.cpp registry); otherwise the GGUF's embedded jinja
    template is rendered; if that is absent or fails, the builtin
    dialect detected from the template text (or chatml) is used."""
    from .templates import apply_builtin_template, detect_template

    if template_override:
        return apply_builtin_template(template_override, messages,
                                      add_generation_prompt)

    import jinja2

    template = model.reader.kv.get("tokenizer.chat_template") or ""
    if not template:
        return apply_builtin_template("chatml", messages, add_generation_prompt)
    env = jinja2.Environment(loader=jinja2.BaseLoader())
    try:
        tpl = env.from_string(template)
        return tpl.render(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            tools=tools or None,
            bos_token="", eos_token="",
        )
    except jinja2.TemplateError:
        return apply_builtin_template(detect_template(template) or "chatml",
                                      messages, add_generation_prompt)


def format_infill(
    vocab,
    input_prefix: str,
    input_suffix: str,
    input_extra: list | None = None,
    n_batch: int = 2048,
    n_predict: int = 128,
    n_ctx: int = 4096,
    spm_infill: bool = False,
    tokens_prompt: list[int] | None = None,
) -> list[int]:
    """Build the FIM prompt (server-common.cpp:1538-1640 format_infill):
    optional repo-level extra chunks, then
    [FIM_PRE]prefix[FIM_SUF]suffix[FIM_MID] (or suffix-prefix-middle when
    spm_infill). Prefix:suffix budget is 3:1 of n_batch."""
    tokens_prompt = tokens_prompt or []

    def tok(t):
        return vocab.tokenize(t, add_special=False, parse_special=False)

    extra_tokens: list[int] = []
    if vocab.fim_rep_id >= 0:
        extra_tokens += [vocab.fim_rep_id] + tok("myproject\n")
    for chunk in input_extra or []:
        text = chunk.get("text", "")
        filename = chunk.get("filename", "tmp")
        if vocab.fim_sep_id >= 0:
            extra_tokens += [vocab.fim_sep_id] + tok(filename + "\n")
        else:
            extra_tokens += tok("\n\n--- snippet ---\n\n")
        extra_tokens += tok(text)
    if vocab.fim_sep_id >= 0:
        extra_tokens += [vocab.fim_sep_id] + tok("filename\n")

    tokens_prefix = tok(input_prefix)
    tokens_suffix = tok(input_suffix)
    n_prefix_take = min(len(tokens_prefix), 3 * (n_batch // 4))
    n_suffix_take = min(len(tokens_suffix), max(0, n_batch // 4 - (2 + len(tokens_prompt))))
    n_extra_take = min(max(0, n_ctx - n_batch - 2 * n_predict), len(extra_tokens))

    tokens_prefix = tokens_prefix[len(tokens_prefix) - n_prefix_take :]
    tokens_suffix = tokens_suffix[:n_suffix_take]
    tokens_prefix = [vocab.fim_pre_id] + tokens_prefix + list(tokens_prompt)
    tokens_suffix = [vocab.fim_suf_id] + tokens_suffix

    embd_inp = tokens_suffix if spm_infill else tokens_prefix
    embd_end = tokens_prefix if spm_infill else tokens_suffix
    if vocab.add_bos:
        embd_inp = [vocab.bos_id] + embd_inp
    embd_inp = (extra_tokens[len(extra_tokens) - n_extra_take :] if n_extra_take else []) + embd_inp
    return embd_inp + embd_end + [vocab.fim_mid_id]


def _make_sampler(body: dict, vocab=None, n_vocab: int = 0) -> SamplerChain | None:
    """Full llama-server sampling-parameter surface
    (tools/server README "completion" params)."""
    temp = float(body.get("temperature", 0.8))
    lb = body.get("logit_bias") or None
    if isinstance(lb, list):  # OpenAI style [[tok, bias], ...]
        lb = {int(t): float(b) for t, b in lb}
    elif isinstance(lb, dict):
        lb = {int(t): float(b) for t, b in lb.items()}
    if temp <= 0:
        # greedy selection still honors logit bias / penalties / dry
        # (common_sampler keeps the chain; only the selector is argmax);
        # bare argmax fast path when no modifier is active
        modifiers = (
            lb
            or float(body.get("repeat_penalty", 1.0)) != 1.0
            or float(body.get("frequency_penalty", 0.0)) != 0.0
            or float(body.get("presence_penalty", 0.0)) != 0.0
            or float(body.get("dry_multiplier", 0.0)) > 0
            or int(body.get("mirostat", 0))
        )
        if not modifiers:
            return None
    return SamplerChain.from_params(
        vocab=vocab,
        seed=int(body.get("seed", 0xFFFFFFFF)),
        temp=temp,
        dynatemp_range=float(body.get("dynatemp_range", 0.0)),
        dynatemp_exponent=float(body.get("dynatemp_exponent", 1.0)),
        top_k=int(body.get("top_k", 40)),
        top_p=float(body.get("top_p", 0.95)),
        min_p=float(body.get("min_p", 0.05)),
        typical_p=float(body.get("typical_p", 1.0)),
        xtc_probability=float(body.get("xtc_probability", 0.0)),
        xtc_threshold=float(body.get("xtc_threshold", 0.1)),
        top_n_sigma=float(body.get("top_n_sigma", -1.0)),
        penalty_last_n=int(body.get("repeat_last_n", 64)),
        penalty_repeat=float(body.get("repeat_penalty", 1.0)),
        penalty_freq=float(body.get("frequency_penalty", 0.0)),
        penalty_present=float(body.get("presence_penalty", 0.0)),
        dry_multiplier=float(body.get("dry_multiplier", 0.0)),
        dry_base=float(body.get("dry_base", 1.75)),
        dry_allowed_length=int(body.get("dry_allowed_length", 2)),
        dry_penalty_last_n=int(body.get("dry_penalty_last_n", -1)),
        dry_sequence_breakers=body.get("dry_sequence_breakers"),
        mirostat=int(body.get("mirostat", 0)),
        mirostat_tau=float(body.get("mirostat_tau", 5.0)),
        mirostat_eta=float(body.get("mirostat_eta", 0.1)),
        logit_bias=lb,
        n_vocab=n_vocab,
    )


def _make_grammar(body: dict, vocab):
    from ..runtime.grammar import Grammar
    from ..runtime.json_schema import json_schema_to_gbnf

    g_text = body.get("grammar")
    schema = body.get("json_schema")
    rf = body.get("response_format")
    if rf and rf.get("type") == "json_schema":
        schema = rf.get("json_schema", {}).get("schema", rf.get("schema", {}))
    elif rf and rf.get("type") == "json_object":
        schema = {"type": "object"}
    if schema is not None and g_text is None:
        g_text = json_schema_to_gbnf(schema)
    if g_text:
        return Grammar.from_gbnf(g_text, vocab=vocab)
    return None


def extract_media(messages: list):
    """OpenAI-style chat content arrays -> (messages with their text parts
    joined, media list). Media parts ({"type": "image_url"} and
    {"type": "input_audio"}) need the multimodal path, which is not ported
    yet (ROADMAP.md Queue 1 item 8): they are refused by name, so the
    media list is always empty."""
    out = []
    for msg in messages:
        content = msg.get("content")
        if not isinstance(content, list):
            out.append(msg)
            continue
        text = ""
        for part in content:
            ptype = part.get("type")
            if ptype == "text":
                text += part.get("text", "")
            elif ptype in ("image_url", "input_audio"):
                raise NotImplementedError(
                    f"{ptype} content: media in chat is not ported yet "
                    "(ROADMAP.md Queue 1 item 8)")
            else:
                raise ValueError(f"unsupported content part type {ptype!r}")
        out.append({**msg, "content": text})
    return out, []


class ServerState:
    def __init__(self, engine: ServerEngine, model_name: str = "model",
                 chat_template: str | None = None,
                 api_key: str | None = None, api_prefix: str = "",
                 no_slots_ep: bool = False, props_rw: bool = False,
                 chat_template_kwargs: dict | None = None,
                 no_webui: bool = False, spm_infill: bool = False,
                 slot_save_path: str | None = None):
        self.engine = engine
        # slot save/restore (requires --slot-save-path like the reference)
        self.slot_save_path = slot_save_path
        self.model_name = model_name
        # --chat-template NAME: force a builtin dialect (templates.py)
        self.chat_template = chat_template
        self.t_start = time.time()
        # --api-key(-file): bearer auth; /health and /v1/models stay open
        # (server.cpp middleware_server_state + API-key check)
        self.api_key = api_key or None
        self.api_prefix = api_prefix.rstrip("/")
        self.no_slots_ep = no_slots_ep  # --no-slots
        self.no_webui = no_webui  # --no-webui: disable the / chat UI
        self.spm_infill = spm_infill  # --spm-infill default token order
        self.props_rw = props_rw  # --props enables POST /props
        self.chat_template_kwargs = chat_template_kwargs or {}


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue 1 item {item})")


def make_handler(state: ServerState):
    engine = state.engine
    vocab = engine.vocab
    tmpl_override = state.chat_template

    def tool_dialect(body: dict) -> str:
        """Tool-call format for this model: explicit chat_format in
        the request, else detected from the embedded jinja template
        (the format-selection role of common_chat_templates_apply)."""
        from .chat import detect_tool_dialect

        fmt = body.get("chat_format")
        if fmt:
            return str(fmt)
        tmpl = engine.model.reader.kv.get("tokenizer.chat_template") or ""
        return detect_tool_dialect(tmpl) if tmpl else "auto"

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        # ---- helpers ----
        def _json(self, obj, code: int = 200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _error(self, msg, code=400, etype="invalid_request_error"):
            self._json({"error": {"message": msg, "type": etype, "code": code}}, code)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n == 0:
                return {}
            try:
                return json.loads(self.rfile.read(n))
            except json.JSONDecodeError:
                raise ValueError("invalid JSON body")

        def _sse_start(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _sse(self, obj):
            data = f"data: {json.dumps(obj)}\n\n".encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        def _sse_done(self):
            data = b"data: [DONE]\n\n"
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")

        def _route(self):
            """Strip --api-prefix and enforce --api-key (public paths
            exempt, matching the reference middleware)."""
            path = self.path.split("?")[0]
            if state.api_prefix and path.startswith(state.api_prefix):
                path = path[len(state.api_prefix):] or "/"
            if state.api_key and path not in ("/health", "/v1/health",
                                              "/v1/models", "/models",
                                              "/api/tags", "/"):
                import hmac

                auth = self.headers.get("Authorization", "")
                xkey = self.headers.get("X-Api-Key", "")
                ok = hmac.compare_digest(
                    auth, f"Bearer {state.api_key}"
                ) or hmac.compare_digest(xkey, state.api_key)
                if not ok:
                    self._error("invalid API key", 401,
                                "authentication_error")
                    return None
            if state.no_slots_ep and path == "/slots":
                self._error("slots endpoint disabled by --no-slots", 501,
                            "not_supported_error")
                return None
            return path

        # ---- GET ----
        def do_GET(self):
            path = self._route()
            if path is None:
                return
            if path == "/" or path == "/index.html":
                # built-in chat web UI (the reference serves its webui
                # SPA from the root route; --no-webui disables)
                if state.no_webui:
                    self._error("webui disabled by --no-webui", 404,
                                "not_found_error")
                    return
                from .webui import INDEX_HTML

                body = INDEX_HTML.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path in ("/health", "/v1/health"):
                self._json({"status": "ok"})
            elif path == "/lora-adapters":
                self._json([])  # no adapters: --lora is not ported yet
            elif path == "/api/tags":
                # ollama tag listing (server.cpp:162)
                self._json({"models": [{
                    "name": state.model_name, "model": state.model_name,
                    "modified_at": int(state.t_start), "size": 0,
                    "details": {"format": "gguf", "family":
                                engine.model.hparams.arch},
                }]})
            elif path == "/v1/models" or path == "/models":
                self._json({
                    "object": "list",
                    "data": [{
                        "id": state.model_name, "object": "model",
                        "created": int(state.t_start), "owned_by": "tpullama",
                    }],
                })
            elif path == "/props":
                hp = engine.model.hparams
                self._json({
                    "model_path": state.model_name,
                    "n_ctx": (engine.ctx or engine.encoder).p.n_ctx
                    * (engine.ctx or engine.encoder).p.n_seqs,
                    "n_ctx_per_seq": (engine.ctx or engine.encoder).p.n_ctx,
                    "total_slots": len(engine.slots),
                    "model": {"arch": hp.arch, "n_embd": hp.n_embd, "n_layer": hp.n_layer,
                              "n_vocab": hp.n_vocab},
                })
            elif path == "/slots":
                self._json([
                    {
                        "id": s.id, "state": s.state.value,
                        "n_past": int(engine.ctx.n_past[s.id]) if engine.ctx is not None else 0,
                        "task_id": s.task.id if s.task else None,
                    }
                    for s in engine.slots
                ])
            elif path == "/metrics":
                # Prometheus text format (server_metrics analog)
                m = engine.metrics
                if engine.ctx is None:
                    return self._json({"note": "encoder model: no decode metrics"})
                p = engine.ctx.perf
                lines = [
                    "# TYPE llamacpp:prompt_tokens_total counter",
                    f"llamacpp:prompt_tokens_total {m['n_prompt_tokens_processed']}",
                    "# TYPE llamacpp:tokens_predicted_total counter",
                    f"llamacpp:tokens_predicted_total {m['n_tokens_predicted']}",
                    "# TYPE llamacpp:requests_total counter",
                    f"llamacpp:requests_total {m['n_requests']}",
                    "# TYPE llamacpp:n_decode_total counter",
                    f"llamacpp:n_decode_total {p.n_decode}",
                    "# TYPE llamacpp:prompt_tokens_seconds gauge",
                    f"llamacpp:prompt_tokens_seconds {p.prefill_tps():.3f}",
                    "# TYPE llamacpp:predicted_tokens_seconds gauge",
                    f"llamacpp:predicted_tokens_seconds {p.decode_tps():.3f}",
                ]
                if engine.draft_model is not None:
                    rate = (m["n_draft_accepted"] / m["n_drafted"]
                            if m["n_drafted"] else 0.0)
                    lines += [
                        "# TYPE llamacpp:draft_tokens_total counter",
                        f"llamacpp:draft_tokens_total {m['n_drafted']}",
                        "# TYPE llamacpp:draft_tokens_acceptance gauge",
                        f"llamacpp:draft_tokens_acceptance {rate:.4f}",
                    ]
                data = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._error(f"unknown endpoint {path}", 404)

        # ---- POST ----
        def do_POST(self):
            path = self._route()
            if path is None:
                return
            try:
                body = self._body()
            except ValueError as e:
                return self._error(str(e))
            try:
                if path in ("/completion", "/completions", "/v1/completions"):
                    self._handle_completion(body, oai=path.startswith("/v1"))
                elif path in ("/chat/completions", "/v1/chat/completions",
                              "/api/chat"):
                    self._handle_chat(body)
                elif path == "/v1/messages":
                    self._handle_anthropic(body)
                elif path == "/v1/messages/count_tokens":
                    self._handle_anthropic_count(body)
                elif path == "/props":
                    # POST /props (gated on --props like the reference's
                    # LLAMA_ARG_ENDPOINT_PROPS)
                    if not state.props_rw:
                        self._error(
                            "POST /props disabled (start with --props)",
                            501, "not_supported_error")
                    else:
                        state.chat_template_kwargs.update(
                            dict(body.get("chat_template_kwargs") or {}))
                        self._json({"success": True})
                elif path.startswith("/slots/"):
                    self._handle_slot_action(path, body)
                elif path == "/lora-adapters":
                    self._handle_set_loras(body)
                elif path == "/api/show":
                    self._json({
                        "template": engine.model.reader.kv.get(
                            "tokenizer.chat_template", ""),
                        "model_info": {
                            "llama.context_length":
                                (engine.ctx or engine.encoder).p.n_ctx,
                        },
                        "modelfile": "", "parameters": "",
                        "details": {"parent_model": "", "format": "gguf",
                                    "family": engine.model.hparams.arch,
                                    "families": [engine.model.hparams.arch],
                                    "parameter_size": "",
                                    "quantization_level": ""},
                        "capabilities": ["completion"],
                    })
                elif path == "/tokenize":
                    toks = vocab.tokenize(
                        body.get("content", ""),
                        add_special=bool(body.get("add_special", False)),
                        parse_special=bool(body.get("parse_special", True)),
                    )
                    self._json({"tokens": toks})
                elif path == "/detokenize":
                    self._json({"content": vocab.detokenize(body.get("tokens", []))})
                elif path == "/apply-template":
                    text = apply_chat_template(engine.model, body.get("messages", []),
                                               template_override=tmpl_override)
                    self._json({"prompt": text})
                elif path in ("/embedding", "/embeddings", "/v1/embeddings"):
                    self._handle_embeddings(body)
                elif path == "/infill":
                    self._handle_infill(body)
                elif path in ("/rerank", "/v1/rerank", "/reranking"):
                    self._handle_rerank(body)
                else:
                    self._error(f"unknown endpoint {path}", 404)
            except BrokenPipeError:
                pass
            except NotImplementedError as e:  # a feature not ported yet, by name
                self._error(str(e), 501, "not_supported_error")
            except Exception as e:  # surface as OAI-style error
                self._error(f"{type(e).__name__}: {e}", 500, "server_error")

        def _handle_embeddings(self, body):
            inputs = body.get("input", body.get("content", ""))
            if isinstance(inputs, str):
                inputs = [inputs]
            # embedding tasks on the decoder's lanes (the JAX package's
            # encoder-model branch waits for the encoder context, Queue 1
            # item 7)
            data = []
            n_prompt = 0
            for i, text in enumerate(inputs):
                toks = vocab.tokenize(text, add_special=True)
                n_prompt += len(toks)
                task = Task(prompt_tokens=toks, embedding=True,
                            pooling=body.get("pooling", "mean"))
                engine.submit(task)
                if engine._thread is None:
                    while not task.done.is_set():
                        engine.step()
                else:
                    task.done.wait(600)
                if task.error:
                    return self._error(task.error)
                data.append({
                    "object": "embedding", "index": i,
                    "embedding": [float(x) for x in task.embedding_out],
                })
            self._json({
                "object": "list", "data": data, "model": state.model_name,
                "usage": {"prompt_tokens": n_prompt, "total_tokens": n_prompt},
            })

        def _submit(self, prompt_text, body) -> tuple[Task, queue.Queue | None]:
            stream = bool(body.get("stream", False))
            toks = vocab.tokenize(prompt_text, add_special=True)
            stop = body.get("stop") or []
            if isinstance(stop, str):
                stop = [stop]
            task = Task(
                prompt_tokens=toks,
                n_predict=int(body.get("n_predict", body.get("max_tokens", 128))),
                sampler=_make_sampler(body, vocab, engine.model.hparams.n_vocab),
                stop=stop,
                stream_queue=queue.Queue() if stream else None,
            )
            task.grammar = _make_grammar(body, vocab)
            engine.submit(task)
            return task, task.stream_queue

        def _handle_rerank(self, body):
            raise _not_ported("/rerank: the rank-pooled encoder path", 7)

        def _handle_infill(self, body):
            """Fill-in-middle completion (server.cpp handle_infill)."""
            if vocab.fim_pre_id < 0 or vocab.fim_suf_id < 0 or vocab.fim_mid_id < 0:
                return self._error(
                    "infill is not supported by this model: missing FIM tokens", 501
                )
            if "input_prefix" not in body and "input_suffix" not in body:
                return self._error("\"input_prefix\" or \"input_suffix\" is required")
            prompt = body.get("prompt", "")
            toks = format_infill(
                vocab,
                body.get("input_prefix", ""),
                body.get("input_suffix", ""),
                body.get("input_extra"),
                n_batch=int(body.get("n_batch", 2048)),
                n_predict=int(body.get("n_predict", 128)),
                n_ctx=(engine.ctx or engine.encoder).p.n_ctx,
                spm_infill=bool(body.get("spm_infill",
                                         state.spm_infill)),
                tokens_prompt=vocab.tokenize(prompt, add_special=False) if prompt else None,
            )
            stop = body.get("stop") or []
            if isinstance(stop, str):
                stop = [stop]
            task = Task(
                prompt_tokens=toks,
                n_predict=int(body.get("n_predict", body.get("max_tokens", 128))),
                sampler=_make_sampler(body, vocab, engine.model.hparams.n_vocab),
                stop=stop,
            )
            engine.submit(task)
            if engine._thread is None:
                while not task.done.is_set():
                    engine.step()
            else:
                task.done.wait(600)
            if task.error:
                return self._error(task.error)
            self._json({
                "content": task.out_text,
                "tokens_predicted": len(task.out_tokens),
                "stop_type": task.stop_reason,
            })

        def _handle_slot_action(self, path: str, body):
            """POST /slots/{id}?action=save|restore|erase
            (server-context.cpp:1542-1650; save and restore require
            --slot-save-path)."""
            from urllib.parse import parse_qs, urlparse

            try:
                slot_id = int(path.split("/")[2])
            except (IndexError, ValueError):
                return self._error("invalid slot id")
            q = parse_qs(urlparse(self.path).query)
            action = (q.get("action") or [""])[0]
            if action in ("save", "restore"):
                if not state.slot_save_path:
                    return self._error(
                        "This server does not support slots action. Start "
                        "it with `--slot-save-path`", 501)
                filename = body.get("filename", "")
                if not filename or "/" in filename or ".." in filename:
                    return self._error("invalid filename")
                filepath = os.path.join(state.slot_save_path, filename)
                try:
                    if action == "save":
                        out = engine.slot_save(slot_id, filepath)
                    else:
                        out = engine.slot_restore(slot_id, filepath)
                except (IndexError, RuntimeError, FileNotFoundError,
                        ValueError) as e:
                    return self._error(str(e))
                out["filename"] = filename
                self._json(out)
            elif action == "erase":
                try:
                    self._json(engine.slot_erase(slot_id))
                except (IndexError, RuntimeError) as e:
                    return self._error(str(e))
            else:
                self._error(f"invalid action {action!r}")

        def _handle_set_loras(self, body):
            raise _not_ported("POST /lora-adapters: LoRA adapters", 6)

        def _handle_anthropic(self, body):
            """Anthropic Messages API (server.cpp:169,
            server-context.cpp:3145)."""
            from .anthropic import (anthropic_final, anthropic_stream_delta,
                                    anthropic_stream_finish,
                                    anthropic_stream_start,
                                    convert_anthropic_to_oai)
            from .chat import (StreamScanner, parse_tool_calls,
                               tools_to_template_ctx)

            try:
                oai = convert_anthropic_to_oai(body)
            except ValueError as e:
                return self._error(str(e))
            messages = oai.get("messages", [])
            tools = tools_to_template_ctx(oai.get("tools"))
            try:
                messages, _ = extract_media(messages)
            except ValueError as e:
                return self._error(str(e))
            prompt = apply_chat_template(engine.model, messages,
                                         tools=tools or None,
                                         template_override=tmpl_override)
            task, sq = self._submit(prompt, oai)
            rid = f"msg_{uuid.uuid4().hex[:16]}"
            if sq is None:
                task.done.wait(600)
                if task.error:
                    return self._error(task.error)
                if tools:
                    from .chat import parse_assistant_message
                    content, _reasoning, tool_calls = parse_assistant_message(
                        task.out_text, tool_dialect(oai))
                else:
                    content, tool_calls = task.out_text, []
                self._json(anthropic_final(
                    rid, state.model_name, content, tool_calls,
                    task.stop_reason, task.stop_word,
                    len(task.prompt_tokens), len(task.out_tokens)))
                return
            # streaming: Anthropic SSE event protocol
            self._sse_start()
            for ev in anthropic_stream_start(
                    rid, state.model_name, len(task.prompt_tokens)):
                self._raw_chunk(ev)
            scanner = StreamScanner(tool_dialect(oai)) if tools else None
            while True:
                piece = sq.get()
                if piece is None:
                    break
                if scanner is not None:
                    piece = scanner.feed(piece)
                if piece:
                    self._raw_chunk(anthropic_stream_delta(piece))
            tool_calls = []
            if scanner is not None:
                tail, tool_calls = scanner.finish()
                if tail and not tool_calls:
                    self._raw_chunk(anthropic_stream_delta(tail))
            for ev in anthropic_stream_finish(
                    tool_calls, task.stop_reason, task.stop_word,
                    len(task.out_tokens)):
                self._raw_chunk(ev)
            self.wfile.write(b"0\r\n\r\n")

        def _handle_anthropic_count(self, body):
            """POST /v1/messages/count_tokens
            (server-context.cpp:3161)."""
            from .anthropic import convert_anthropic_to_oai
            from .chat import tools_to_template_ctx

            try:
                oai = convert_anthropic_to_oai(body)
            except ValueError as e:
                return self._error(str(e))
            messages, _ = extract_media(oai.get("messages", []))
            tools = tools_to_template_ctx(oai.get("tools"))
            prompt = apply_chat_template(engine.model, messages,
                                         tools=tools or None,
                                         template_override=tmpl_override)
            toks = vocab.tokenize(prompt, add_special=True)
            self._json({"input_tokens": len(toks)})

        def _raw_chunk(self, data: bytes):
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        def _handle_completion(self, body, oai: bool):
            prompt = body.get("prompt", "")
            task, sq = self._submit(prompt, body)
            rid = f"cmpl-{uuid.uuid4().hex[:12]}"
            if sq is None:
                task.done.wait(600)
                if task.error:
                    return self._error(task.error)
                if oai:
                    self._json({
                        "id": rid, "object": "text_completion",
                        "created": int(time.time()), "model": state.model_name,
                        "choices": [{"text": task.out_text, "index": 0,
                                     "finish_reason": task.stop_reason or "stop"}],
                        "usage": {
                            "prompt_tokens": len(task.prompt_tokens),
                            "completion_tokens": len(task.out_tokens),
                            "total_tokens": len(task.prompt_tokens) + len(task.out_tokens),
                        },
                    })
                else:
                    self._json({
                        "content": task.out_text,
                        "tokens_predicted": len(task.out_tokens),
                        "stop_type": task.stop_reason,
                        "timings": {"ttft_ms": task.ttft_ms},
                    })
                return
            self._sse_start()
            while True:
                piece = sq.get()
                if piece is None:
                    break
                if oai:
                    self._sse({
                        "id": rid, "object": "text_completion",
                        "choices": [{"text": piece, "index": 0, "finish_reason": None}],
                    })
                else:
                    self._sse({"content": piece, "stop": False})
            if oai:
                self._sse({
                    "id": rid, "object": "text_completion",
                    "choices": [{"text": "", "index": 0,
                                 "finish_reason": task.stop_reason or "stop"}],
                })
            else:
                self._sse({"content": "", "stop": True, "stop_type": task.stop_reason})
            self._sse_done()

        def _handle_chat(self, body):
            from .chat import parse_tool_calls, tools_to_template_ctx

            messages = body.get("messages", [])
            tools_body = body.get("tools")
            if tools_body is not None and not isinstance(tools_body, list):
                return self._error('"tools" must be an array of tool specs')
            tools = tools_to_template_ctx(tools_body)
            try:
                messages, _ = extract_media(messages)
            except ValueError as e:
                return self._error(str(e))
            prompt = apply_chat_template(engine.model, messages, tools=tools or None,
                                         template_override=tmpl_override)
            task, sq = self._submit(prompt, body)
            rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            created = int(time.time())
            if sq is None:
                task.done.wait(600)
                if task.error:
                    return self._error(task.error)
                reasoning = ""
                if tools:
                    from .chat import parse_assistant_message
                    content, reasoning, tool_calls = parse_assistant_message(
                        task.out_text, tool_dialect(body))
                else:
                    content, tool_calls = task.out_text, []
                message = {"role": "assistant", "content": content or None}
                if reasoning:
                    message["reasoning_content"] = reasoning
                finish = task.stop_reason or "stop"
                if tool_calls:
                    message["tool_calls"] = tool_calls
                    finish = "tool_calls"
                self._json({
                    "id": rid, "object": "chat.completion", "created": created,
                    "model": state.model_name,
                    "choices": [{
                        "index": 0,
                        "message": message,
                        "finish_reason": finish,
                    }],
                    "usage": {
                        "prompt_tokens": len(task.prompt_tokens),
                        "completion_tokens": len(task.out_tokens),
                        "total_tokens": len(task.prompt_tokens) + len(task.out_tokens),
                    },
                })
                return
            from .chat import StreamScanner

            self._sse_start()
            first = True

            def chunk(delta, finish=None):
                nonlocal first
                if first and "role" not in delta and finish is None:
                    delta = {"role": "assistant", **delta}
                    first = False
                self._sse({
                    "id": rid, "object": "chat.completion.chunk",
                    "created": created,
                    "choices": [{"index": 0, "delta": delta,
                                 "finish_reason": finish}],
                })

            # with tools enabled, hold back potential tool-call text and
            # emit structured tool_calls deltas instead (the reference's
            # streaming diff logic, common/chat.cpp)
            scanner = StreamScanner(tool_dialect(body)) if tools else None
            while True:
                piece = sq.get()
                if piece is None:
                    break
                if scanner is not None:
                    piece = scanner.feed(piece)
                if piece:
                    chunk({"content": piece})
            finish = task.stop_reason or "stop"
            if scanner is not None:
                tail, tool_calls = scanner.finish()
                if tail and not tool_calls:
                    chunk({"content": tail})
                for i, call in enumerate(tool_calls):
                    chunk({"tool_calls": [{
                        "index": i, "id": call["id"], "type": "function",
                        "function": {
                            "name": call["function"]["name"],
                            "arguments": "",
                        },
                    }]})
                    chunk({"tool_calls": [{
                        "index": i,
                        "function": {
                            "arguments": call["function"]["arguments"],
                        },
                    }]})
                if tool_calls:
                    finish = "tool_calls"
            chunk({}, finish=finish)
            self._sse_done()

    return Handler


def serve(model, host: str = "127.0.0.1", port: int = 8080, n_slots: int = 4,
          n_ctx: int = 1024, model_name: str = "model", block: bool = True,
          mmproj: str | None = None, slot_save_path: str | None = None,
          loras: list[tuple[str, float]] | None = None,
          draft_model=None, spec_params=None, kv_unified: bool = False,
          split_mode: str = "none", n_shards: int = 0,
          chat_template: str | None = None,
          api_key: str | None = None, api_prefix: str = "",
          no_slots_ep: bool = False, props_rw: bool = False,
          timeout: int = 0, ssl_cert: str = "", ssl_key: str = "",
          chat_template_kwargs: dict | None = None,
          no_webui: bool = False, spm_infill: bool = False):
    """Serve `model` (a LoadedModel on the card, or on the CPU) through a
    ServerEngine of n_slots slots of n_ctx cells, f32 activations and KV
    cache as in the JAX package; `draft_model` (on the same device) and
    `spec_params` turn on per-slot speculative decoding. The options of
    features not ported yet are refused by name. `slot_save_path`: the
    directory the slot save and restore actions write and read (None:
    they answer 501, as in the JAX package)."""
    for on, what, item in ((mmproj, "mmproj: the multimodal path", 8),
                           (loras, "loras: LoRA adapters", 6),
                           (kv_unified, "kv_unified: the unified KV pool", 6),
                           (split_mode != "none" or n_shards > 1,
                            f"split_mode={split_mode!r}: the multi-card split modes", 10)):
        if on:
            raise _not_ported(what, item)
    engine = ServerEngine(model, n_slots=n_slots, n_ctx=n_ctx,
                          draft_model=draft_model, spec_params=spec_params)
    engine.start()
    state = ServerState(engine, model_name,
                        chat_template=chat_template,
                        api_key=api_key, api_prefix=api_prefix,
                        no_slots_ep=no_slots_ep, props_rw=props_rw,
                        no_webui=no_webui, spm_infill=spm_infill,
                        chat_template_kwargs=chat_template_kwargs,
                        slot_save_path=slot_save_path)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    if ssl_cert and ssl_key:
        import ssl as _ssl

        sctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
        sctx.load_cert_chain(ssl_cert, ssl_key)
        httpd.socket = sctx.wrap_socket(httpd.socket, server_side=True)
    if timeout:
        # per-connection read/write timeout (the reference's --timeout);
        # BaseServer.serve_forever never consults self.timeout, so set a
        # socket timeout on each accepted connection instead
        httpd.timeout = timeout
        _orig_get_request = httpd.get_request

        def _get_request():
            conn, addr = _orig_get_request()
            conn.settimeout(timeout)
            return conn, addr

        httpd.get_request = _get_request
    httpd.engine = engine
    if block:
        try:
            httpd.serve_forever()
        finally:
            engine.stop()
    else:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
    return httpd


def main(argv=None):
    from ..tools.args import build_parser as common_parser

    ap = common_parser("server", prog="tpullama-server",
                       model_required=False)
    ap.set_defaults(parallel=4)  # registry -np/--parallel (slot count)
    ap.add_argument("--lora-scaled", action="append", nargs=2, default=[],
                    metavar=("PATH", "SCALE"),
                    help="LoRA adapter GGUF with a custom scale (repeatable)")
    ap.add_argument("--kv-unified", "-kvu", action="store_true",
                    default=os.environ.get("LLAMA_ARG_KV_UNIFIED", "")
                    not in ("", "0"),
                    help="one shared KV cell pool across slots (n_ctx = "
                         "total; the reference's kv_unified)")
    args = ap.parse_args(argv)
    if not args.model and getattr(args, "hf_repo", ""):
        from ..models.download import model_path_from_args

        args.model = model_path_from_args(args)
    if not args.model:
        ap.error("the following arguments are required: -m/--model")
    for on, what, item in ((args.lora or args.lora_scaled, "--lora: LoRA adapters", 6),
                           (args.mmproj, "--mmproj: the multimodal path", 8),
                           (args.kv_unified, "--kv-unified: the unified KV pool", 6),
                           (args.split_mode != "none",
                            f"--split-mode {args.split_mode}: the multi-card split modes",
                            10)):
        if on:
            raise _not_ported(what, item)
    from ..models import load_model
    from ..tools.args import apply_model_arg_overrides

    model = load_model(args.model, device=args.device)
    apply_model_arg_overrides(model, args)
    draft_model = spec_params = None
    if args.model_draft:
        from ..runtime.speculative import SpeculativeParams

        draft_model = load_model(args.model_draft, device=args.device)
        spec_params = SpeculativeParams(n_draft=args.draft_max, p_min=args.draft_p_min)
    api_key = args.api_key or None
    if args.api_key_file:
        api_key = open(args.api_key_file).read().strip()
    ctk = {}
    if args.chat_template_kwargs:
        ctk = json.loads(args.chat_template_kwargs)
    chat_template = args.chat_template or None
    if not chat_template and args.chat_template_file:
        chat_template = open(args.chat_template_file).read()
    scheme = "https" if (args.ssl_cert_file and args.ssl_key_file) else "http"
    print(f"serving {args.model} on {scheme}://{args.host}:{args.port} "
          f"({args.parallel} slots x {args.ctx_size} ctx)")
    serve(model, args.host, args.port, n_slots=args.parallel,
          n_ctx=args.ctx_size,
          model_name=args.alias or args.model,
          slot_save_path=args.slot_save_path or None,
          draft_model=draft_model, spec_params=spec_params,
          chat_template=chat_template,
          api_key=api_key, api_prefix=args.api_prefix,
          no_slots_ep=args.no_slots, props_rw=args.props,
          no_webui=getattr(args, "no_webui", False),
          spm_infill=getattr(args, "spm_infill", False),
          timeout=args.timeout, ssl_cert=args.ssl_cert_file,
          ssl_key=args.ssl_key_file, chat_template_kwargs=ctk)


if __name__ == "__main__":
    main()
