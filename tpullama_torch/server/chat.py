"""Chat tool-call parsing (common/chat.cpp + common/chat-parser.cpp
analog).

The reference detects the template family and extracts structured tool
calls (and reasoning) from the raw generation. Auto-detected formats:

  hermes   <tool_call>{"name": ..., "arguments": {...}}</tool_call>
           (Hermes-2-Pro, Qwen2.5/Qwen3 ChatML)
  mistral  [TOOL_CALLS][{"name": ..., "arguments": {...}}, ...]
  llama3   {"name": ..., "parameters": {...}} as the whole message
           (Llama-3.1/3.3 json tool calling)
  generic  first JSON object with "name" + "arguments"/"parameters"

Named dialects mirror chat-parser.cpp's per-format parsers:
deepseek-r1, deepseek-v31, command-r7b, granite, gpt-oss (harmony
channels), firefunction-v2, functionary-v3.1, functionary-v3.2,
nemotron-v2, apertus, lfm2, minimax-m2, qwen3-coder, seed-oss, glm-4.5,
kimi-k2, apriel, xiaomi-mimo, magistral.

parse_tool_calls() returns (content_without_calls, [tool_calls]) where
each call is OpenAI-shaped: {id, type: "function",
function: {name, arguments<json string>}}. parse_assistant_message()
additionally separates reasoning_content (<think> and per-dialect
equivalents, like the reference's reasoning_format=deepseek).
"""

from __future__ import annotations

import json
import re
import uuid


def _mk_call(name: str, args) -> dict:
    if not isinstance(args, str):
        args = json.dumps(args)
    return {
        "id": f"call_{uuid.uuid4().hex[:12]}",
        "type": "function",
        "function": {"name": name, "arguments": args},
    }


def _json_objects(text: str):
    """Yield (obj, start, end) for each parseable top-level JSON object."""
    dec = json.JSONDecoder()
    i = 0
    while True:
        j = text.find("{", i)
        if j < 0:
            return
        try:
            obj, end = dec.raw_decode(text[j:])
            yield obj, j, j + end
            i = j + end
        except json.JSONDecodeError:
            i = j + 1


def parse_tool_calls(text: str, dialect: str = "auto"):
    """Extract tool calls from generated text. Returns (content, calls)."""
    calls = []

    if dialect in ("auto", "hermes"):
        # <tool_call> ... </tool_call> (possibly unterminated at EOG)
        pat = re.compile(r"<tool_call>\s*(.*?)\s*(?:</tool_call>|$)", re.S)
        out = []
        last = 0
        for m in pat.finditer(text):
            try:
                obj = json.loads(m.group(1))
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and "name" in obj:
                calls.append(_mk_call(obj["name"], obj.get("arguments", {})))
                out.append(text[last : m.start()])
                last = m.end()
        if calls:
            out.append(text[last:])
            return "".join(out).strip(), calls

    if dialect in ("auto", "mistral"):
        m = re.search(r"\[TOOL_CALLS\]\s*(\[.*)", text, re.S)
        if m:
            try:
                arr = json.loads(m.group(1))
            except json.JSONDecodeError:
                arr = None
            if isinstance(arr, list):
                for obj in arr:
                    if isinstance(obj, dict) and "name" in obj:
                        calls.append(_mk_call(obj["name"], obj.get("arguments", {})))
                if calls:
                    return text[: m.start()].strip(), calls

    if dialect in ("auto", "llama3", "generic"):
        for obj, start, end in _json_objects(text):
            if not isinstance(obj, dict) or "name" not in obj:
                continue
            args = obj.get("arguments", obj.get("parameters"))
            if args is None:
                continue
            calls.append(_mk_call(obj["name"], args))
            content = (text[:start] + text[end:]).strip()
            return content, calls

    return text, []


class StreamScanner:
    """Incremental content/tool-call splitter for streamed chat with
    tools enabled (the reference's streaming diff machinery in
    common/chat-parser.cpp, reduced to marker holdback).

    feed(piece) returns the text that is safe to stream as content —
    everything up to the first byte that might begin a tool call is
    released; once a call marker is seen the rest is buffered.
    finish() parses the held-back tail and returns (content_tail, calls).
    """

    # any of these starting means "a tool call may follow"
    _MARKERS = ("<tool_call>", "[TOOL_CALLS]", "{")

    # per-dialect hold-back markers (the grammar trigger words of
    # common_chat_templates_apply)
    _DIALECT_MARKERS = {
        "deepseek-r1": ("<｜tool▁calls▁begin｜>", "<｜tool▁call▁begin｜>"),
        "deepseek-v31": ("<｜tool▁calls▁begin｜>", "<｜tool▁call▁begin｜>"),
        "command-r7b": ("<|START_ACTION|>",),
        "granite": ("<|tool_call|>",),
        "gpt-oss": ("<|channel|>", "<|start|>"),
        "firefunction-v2": ("functools[",),
        "functionary-v3.1": ("<function=", "<|python_tag|>"),
        "functionary-v3.2": (">>>",),
        "nemotron-v2": ("<TOOLCALL>",),
        "apertus": ("<|tools_prefix|>",),
        "lfm2": ("<|tool_call_start|>",),
        "minimax-m2": ("<minimax:tool_call>",),
        "qwen3-coder": ("<tool_call>",),
        "seed-oss": ("<seed:tool_call>",),
        "glm-4.5": ("<tool_call>",),
        "kimi-k2": ("<|tool_calls_section_begin|>",),
        "apriel": ("<tool_calls>",),
        "xiaomi-mimo": ("<tool_call>",),
        "magistral": ("[TOOL_CALLS]",),
        "hermes": ("<tool_call>",),
    }

    def __init__(self, dialect: str = "auto"):
        self.dialect = dialect
        self.markers = self._DIALECT_MARKERS.get(dialect, self._MARKERS)
        self.buf = ""          # held-back text (possible tool-call)
        self.locked = False    # a full marker was seen: hold everything

    def _safe_split(self, text: str) -> tuple[str, str]:
        """(emit, hold): emit text certain not to be part of a call."""
        # full marker present -> hold from there on, permanently
        first = -1
        for m in self.markers:
            i = text.find(m)
            if i >= 0 and (first < 0 or i < first):
                first = i
        if first >= 0:
            self.locked = True
            return text[:first], text[first:]
        # partial marker at the very end -> hold just the suffix
        maxlen = max(len(m) for m in self.markers)
        for n in range(min(len(text), maxlen), 0, -1):
            suffix = text[-n:]
            if any(m.startswith(suffix) for m in self.markers):
                return text[:-n], suffix
        return text, ""

    def feed(self, piece: str) -> str:
        if self.locked:
            self.buf += piece
            return ""
        emit, self.buf = self._safe_split(self.buf + piece)
        return emit

    def finish(self) -> tuple[str, list]:
        """Parse the held-back tail. Returns (content_tail, calls)."""
        if not self.buf:
            return "", []
        if self.dialect in _DIALECTS:
            content, _reasoning, calls = parse_assistant_message(
                self.buf, self.dialect)
        else:
            content, calls = parse_tool_calls(self.buf, self.dialect)
        if calls:
            return content, calls
        return self.buf, []


def tools_to_template_ctx(tools: list | None) -> list:
    """Normalize the OpenAI `tools` array for jinja chat templates (most
    templates iterate `tools` as [{type, function: {name, description,
    parameters}}])."""
    out = []
    if not isinstance(tools, list):
        return out
    for t in tools:
        if not isinstance(t, dict):
            continue
        if t.get("type") == "function" and "function" in t:
            out.append(t)
        elif "name" in t:  # bare function spec
            out.append({"type": "function", "function": t})
    return out


# ---------------------------------------------------------------------------
# named dialect parsers (common/chat-parser.cpp per-format functions)
# ---------------------------------------------------------------------------

def _strip_reasoning(text: str, open_tag: str = "<think>",
                     close_tag: str = "</think>") -> tuple[str, str]:
    """Extract a leading reasoning block (try_parse_reasoning analog).
    Returns (rest, reasoning). An unclosed open tag consumes the rest as
    reasoning (thinking-forced-open behavior)."""
    s = text.lstrip()
    if not s.startswith(open_tag):
        return text, ""
    s = s[len(open_tag):]
    end = s.find(close_tag)
    if end < 0:
        return "", s.strip()
    return s[end + len(close_tag):], s[:end].strip()


def _args_str(val) -> str:
    if isinstance(val, str):
        return val
    return json.dumps(val)


def _calls_from_array(arr, name_key="name", args_key="arguments") -> list:
    calls = []
    if not isinstance(arr, list):
        return calls
    for obj in arr:
        if isinstance(obj, dict) and name_key in obj:
            calls.append(_mk_call(obj[name_key], obj.get(args_key, {})))
    return calls


def _parse_deepseek_block(text: str, call_re: re.Pattern) -> tuple[str, list]:
    """Shared deepseek r1/v3.1 block walk: content outside the
    <｜tool▁calls▁begin｜>...<｜tool▁calls▁end｜> span, calls inside."""
    block_open = re.compile(
        "<｜tool▁calls▁begin｜>|<｜tool_calls_begin｜>|<｜tool calls begin｜>"
        "|<｜tool\\\\_calls\\\\_begin｜>|<｜tool▁calls｜>")
    m = block_open.search(text)
    if not m:
        return text, []
    calls = []
    for cm in call_re.finditer(text, m.end()):
        try:
            args = json.loads(cm.group(2))
        except json.JSONDecodeError:
            continue
        calls.append(_mk_call(cm.group(1).strip(), args))
    content = text[: m.start()]
    endm = re.search("<｜tool▁calls▁end｜>", text)
    if endm:
        content += text[endm.end():]
    return content.strip(), calls


def _parse_deepseek_r1(text: str):
    # function<｜tool▁sep｜>NAME\n```json\nJSON\n```<｜tool▁call▁end｜>
    text, reasoning = _strip_reasoning(text)
    call_re = re.compile(
        r"(?:<｜tool▁call▁begin｜>)?function<｜tool▁sep｜>([^\n]+)\n"
        r"```json\n(.*?)```[\s]*<｜tool▁call▁end｜>", re.S)
    content, calls = _parse_deepseek_block(text, call_re)
    return content, reasoning, calls


def _parse_deepseek_v31(text: str):
    # NAME<｜tool▁sep｜>JSON<｜tool▁call▁end｜>
    text, reasoning = _strip_reasoning(text)
    call_re = re.compile(
        r"(?:<｜tool▁call▁begin｜>)?([^\n<｜]+)<｜tool▁sep｜>(.*?)"
        r"[\s]*<｜tool▁call▁end｜>", re.S)
    content, calls = _parse_deepseek_block(text, call_re)
    return content, reasoning, calls


def _parse_command_r7b(text: str):
    text, reasoning = _strip_reasoning(
        text, "<|START_THINKING|>", "<|END_THINKING|>")
    calls = []
    m = re.search(r"<\|START_ACTION\|>(.*?)(?:<\|END_ACTION\|>|$)", text, re.S)
    content = text
    if m:
        try:
            arr = json.loads(m.group(1))
        except json.JSONDecodeError:
            arr = None
        if isinstance(arr, list):
            for obj in arr:
                if isinstance(obj, dict):
                    call = _mk_call(obj.get("tool_name", ""),
                                    obj.get("parameters", {}))
                    if obj.get("tool_call_id"):
                        call["id"] = obj["tool_call_id"]
                    calls.append(call)
            content = (text[: m.start()] + text[m.end():])
    rm = re.search(r"<\|START_RESPONSE\|>(.*?)(?:<\|END_RESPONSE\|>|$)",
                   content, re.S)
    if rm:
        content = rm.group(1)
    return content.strip(), reasoning, calls


def _parse_granite(text: str):
    text, reasoning = _strip_reasoning(text)
    rm = re.search(r"<response>(.*?)(?:</response>|$)", text, re.S)
    pre = text
    if rm:
        pre = text[: rm.start()] + rm.group(1) + text[rm.end():]
    m = re.search(r"<\|tool_call\|>\s*(\[.*)", pre, re.S)
    if not m:
        return pre.strip(), reasoning, []
    try:
        arr = json.loads(m.group(1))
    except json.JSONDecodeError:
        return pre.strip(), reasoning, []
    return pre[: m.start()].strip(), reasoning, _calls_from_array(arr)


def _parse_gpt_oss(text: str):
    """Harmony channels (common_chat_parse_gpt_oss): each message is
    HEADER<|message|>BODY(<|end|> | <|call|> | <|return|> | EOF); headers
    carry the channel and an optional ` to=functions.NAME` recipient."""
    recipient_re = re.compile(r" to=functions\.([^<\s]+)")
    content_parts, reasoning_parts, calls = [], [], []
    # drop leading "<|start|>assistant" wrappers, split on message starts
    for seg in re.split(r"<\|start\|>assistant", text):
        pos = 0
        while True:
            hm = seg.find("<|message|>", pos)
            if hm < 0:
                break
            header = seg[pos:hm]
            body_start = hm + len("<|message|>")
            em = re.search(r"<\|end\|>|<\|call\|>|<\|return\|>",
                           seg[body_start:])
            if em:
                body = seg[body_start : body_start + em.start()]
                pos = body_start + em.end()
            else:
                body = seg[body_start:]
                pos = len(seg)
            rm = recipient_re.search(header)
            if rm:
                try:
                    calls.append(_mk_call(rm.group(1), json.loads(body)))
                except json.JSONDecodeError:
                    calls.append(_mk_call(rm.group(1), body))
            elif "<|channel|>analysis" in header:
                reasoning_parts.append(body)
            else:  # final / commentary preamble
                content_parts.append(body)
    return ("".join(content_parts), "\n".join(reasoning_parts).strip(), calls)


def _parse_firefunction(text: str):
    m = re.search(r" ?functools(\[.*)", text, re.S)
    if not m:
        return text, "", []
    try:
        arr = json.loads(m.group(1))
    except json.JSONDecodeError:
        return text, "", []
    return text[: m.start()].strip(), "", _calls_from_array(arr)


def _parse_functionary_v31(text: str):
    # <function=NAME>{json}</function>; <|python_tag|>code -> python call
    calls = []
    out, last = [], 0
    for m in re.finditer(r"<function=(\w+)>(.*?)</function>", text, re.S):
        try:
            args = json.loads(m.group(2))
        except json.JSONDecodeError:
            continue
        calls.append(_mk_call(m.group(1), args))
        out.append(text[last : m.start()])
        last = m.end()
    rest = text[last:]
    pm = re.search(r"<\|python_tag\|>(.*)", rest, re.S)
    if pm:
        calls.append(_mk_call("python", {"code": pm.group(1)}))
        rest = rest[: pm.start()]
    out.append(rest)
    return "".join(out).strip(), "", calls


def _parse_functionary_v32(text: str):
    # NAME\n{json} at start; subsequent calls prefixed with >>>NAME\n
    # "all" pseudo-function carries plain content; python gets raw code
    calls = []
    content = []
    chunks = re.split(r">>>", text)
    for i, chunk in enumerate(chunks):
        m = re.match(r"\s*(\w+)\n(.*)", chunk, re.S)
        if not m:
            if chunk.strip():
                content.append(chunk)
            continue
        name, body = m.group(1), m.group(2)
        if name == "all":
            content.append(body)
        elif name == "python" and not body.lstrip().startswith("{"):
            calls.append(_mk_call("python", {"code": body}))
        else:
            try:
                calls.append(_mk_call(name, json.loads(body)))
            except json.JSONDecodeError:
                if i == 0:
                    content.append(chunk)
    if not calls:
        return text, "", []
    return "".join(content).strip(), "", calls


def _parse_nemotron_v2(text: str):
    text, reasoning = _strip_reasoning(text)
    m = re.search(r"<TOOLCALL>(.*?)</TOOLCALL>", text, re.S)
    if not m:
        return text.strip(), reasoning, []
    try:
        arr = json.loads(m.group(1))
    except json.JSONDecodeError:
        return text.strip(), reasoning, []
    content = (text[: m.start()] + text[m.end():]).strip()
    return content, reasoning, _calls_from_array(arr)


def _parse_apertus(text: str):
    text, reasoning = _strip_reasoning(
        text, "<|inner_prefix|>", "<|inner_suffix|>")
    m = re.search(r"<\|tools_prefix\|>(.*?)<\|tools_suffix\|>", text, re.S)
    if not m:
        return text.strip(), reasoning, []
    calls = []
    try:
        arr = json.loads(m.group(1))
    except json.JSONDecodeError:
        return text.strip(), reasoning, []
    for obj in arr:
        # short form: {"tool_name": {...args...}}
        if isinstance(obj, dict) and len(obj) == 1:
            name, args = next(iter(obj.items()))
            calls.append(_mk_call(name, args))
    content = (text[: m.start()] + text[m.end():]).strip()
    return content, reasoning, calls


def _parse_lfm2(text: str):
    calls, out, last = [], [], 0
    for m in re.finditer(
            r"<\|tool_call_start\|>(.*?)<\|tool_call_end\|>", text, re.S):
        try:
            arr = json.loads(m.group(1))
        except json.JSONDecodeError:
            continue
        got = _calls_from_array(arr)
        if got:
            calls += got
            out.append(text[last : m.start()])
            last = m.end()
    out.append(text[last:])
    return "".join(out).strip(), "", calls


def _xml_calls(text: str, scope_start: str, tool_re: re.Pattern,
               param_re: re.Pattern, scope_end: str,
               trim_vals: bool = True):
    """Shared XML-ish tool-call walk (chat-parser-xml-toolcall.cpp):
    scope wrapper > per-tool element > key/value parameters. Parameter
    values that parse as JSON stay typed; otherwise they are strings."""
    calls, spans = [], []
    for tm in tool_re.finditer(text):
        name, body = tm.group(1), tm.group(2)
        args = {}
        for pm in param_re.finditer(body):
            key, val = pm.group(1), pm.group(2)
            if trim_vals:
                val = val.strip("\n")
            try:
                args[key] = json.loads(val)
            except (json.JSONDecodeError, ValueError):
                args[key] = val
        calls.append(_mk_call(name.strip(), args))
        spans.append((tm.start(), tm.end()))
    if not calls:
        return text, []
    out, last = [], 0
    for s, e in spans:
        out.append(text[last:s])
        last = e
    out.append(text[last:])
    content = "".join(out)
    if scope_start:
        content = content.replace(scope_start, "")
    if scope_end:
        content = content.replace(scope_end, "")
    return content.strip(), calls


def _parse_minimax_m2(text: str):
    text, reasoning = _strip_reasoning(text)
    content, calls = _xml_calls(
        text, "<minimax:tool_call>",
        re.compile(r'<invoke name="([^"]+)">(.*?)</invoke>', re.S),
        re.compile(r'<parameter name="([^"]+)">(.*?)</parameter>', re.S),
        "</minimax:tool_call>")
    return content, reasoning, calls


def _parse_qwen3_coder(text: str):
    text, reasoning = _strip_reasoning(text)
    content, calls = _xml_calls(
        text, "<tool_call>",
        re.compile(r"<function=([^>]+)>(.*?)</function>", re.S),
        re.compile(r"<parameter=([^>]+)>(.*?)</parameter>", re.S),
        "</tool_call>")
    return content, reasoning, calls


def _parse_seed_oss(text: str):
    text, reasoning = _strip_reasoning(text, "<seed:think>", "</seed:think>")
    content, calls = _xml_calls(
        text, "<seed:tool_call>",
        re.compile(r"<function=([^>]+)>(.*?)</function>", re.S),
        re.compile(r"<parameter=([^>]+)>(.*?)</parameter>", re.S),
        "</seed:tool_call>")
    return content, reasoning, calls


def _parse_glm45(text: str):
    text, reasoning = _strip_reasoning(text)
    content, calls = _xml_calls(
        text, "",
        re.compile(r"<tool_call>\s*([^\n<]+)(.*?)</tool_call>", re.S),
        re.compile(r"<arg_key>(.*?)</arg_key>\s*<arg_value>(.*?)</arg_value>",
                   re.S),
        "")
    return content, reasoning, calls


def _parse_kimi_k2(text: str):
    text, reasoning = _strip_reasoning(text)
    calls = []
    m = re.search(r"<\|tool_calls_section_begin\|>(.*?)"
                  r"(?:<\|tool_calls_section_end\|>|$)", text, re.S)
    if not m:
        return text.strip(), reasoning, []
    for cm in re.finditer(
            r"<\|tool_call_begin\|>\s*(.*?)\s*<\|tool_call_argument_begin\|>"
            r"(.*?)<\|tool_call_end\|>", m.group(1), re.S):
        tid, body = cm.group(1), cm.group(2)
        # tool id looks like functions.NAME:IDX
        nm = re.match(r"functions\.(.+?):\d+$", tid)
        name = nm.group(1) if nm else tid
        try:
            calls.append(_mk_call(name, json.loads(body)))
        except json.JSONDecodeError:
            continue
    content = (text[: m.start()] + text[m.end():]).strip()
    return content, reasoning, calls


def _parse_apriel(text: str):
    text, reasoning = _strip_reasoning(text, "<thinking>", "</thinking>")
    m = re.search(r"<tool_calls>(\[.*?\])</tool_calls>", text, re.S)
    if not m:
        return text.strip(), reasoning, []
    try:
        arr = json.loads(m.group(1))
    except json.JSONDecodeError:
        return text.strip(), reasoning, []
    content = (text[: m.start()] + text[m.end():]).strip()
    return content, reasoning, _calls_from_array(arr)


def _parse_xiaomi_mimo(text: str):
    calls, out, last = [], [], 0
    for m in re.finditer(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", text, re.S):
        try:
            obj = json.loads(m.group(1))
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and "name" in obj:
            calls.append(_mk_call(obj["name"], obj.get("arguments", {})))
            out.append(text[last : m.start()])
            last = m.end()
    out.append(text[last:])
    return "".join(out).strip(), "", calls


def _parse_magistral(text: str):
    text, reasoning = _strip_reasoning(text, "[THINK]", "[/THINK]")
    content, calls = parse_tool_calls(text, "mistral")
    return content, reasoning, calls


def _parse_hermes(text: str):
    text, reasoning = _strip_reasoning(text)
    content, calls = parse_tool_calls(text, "hermes")
    return content, reasoning, calls


def _parse_auto(text: str):
    text, reasoning = _strip_reasoning(text)
    content, calls = parse_tool_calls(text, "auto")
    return content, reasoning, calls


# named dialect -> parser returning (content, reasoning, calls);
# names follow common_chat_format_name (chat.cpp)
_DIALECTS = {
    "deepseek-r1": _parse_deepseek_r1,
    "deepseek-v31": _parse_deepseek_v31,
    "command-r7b": _parse_command_r7b,
    "granite": _parse_granite,
    "gpt-oss": _parse_gpt_oss,
    "firefunction-v2": _parse_firefunction,
    "functionary-v3.1": _parse_functionary_v31,
    "functionary-v3.2": _parse_functionary_v32,
    "nemotron-v2": _parse_nemotron_v2,
    "apertus": _parse_apertus,
    "lfm2": _parse_lfm2,
    "minimax-m2": _parse_minimax_m2,
    "qwen3-coder": _parse_qwen3_coder,
    "seed-oss": _parse_seed_oss,
    "glm-4.5": _parse_glm45,
    "kimi-k2": _parse_kimi_k2,
    "apriel": _parse_apriel,
    "xiaomi-mimo": _parse_xiaomi_mimo,
    "magistral": _parse_magistral,
    "hermes": _parse_hermes,
}

TOOL_DIALECTS = sorted(_DIALECTS) + ["auto", "mistral", "llama3", "generic"]


def parse_assistant_message(text: str, dialect: str = "auto"):
    """Parse a raw assistant generation into
    (content, reasoning_content, tool_calls); the dialect names mirror
    common_chat_format_name (common/chat.cpp)."""
    fn = _DIALECTS.get(dialect)
    if fn is not None:
        return fn(text)
    if dialect == "auto":
        return _parse_auto(text)
    if dialect in ("mistral", "llama3", "generic"):
        content, calls = parse_tool_calls(text, dialect)
        return content, "", calls
    raise KeyError(f"unknown tool-call dialect: {dialect!r}")


def detect_tool_dialect(template_text: str) -> str:
    """Map a jinja chat template to the tool-call dialect its model
    emits (the format-selection role of common_chat_templates_apply)."""
    t = template_text
    if "<|channel|>" in t:
        return "gpt-oss"
    if "<｜tool▁calls▁begin｜>" in t or "<｜tool▁sep｜>" in t:
        return "deepseek-r1"
    if "<|START_ACTION|>" in t:
        return "command-r7b"
    if "<|tool_call|>" in t and "<|start_of_role|>" in t:
        return "granite"
    if " functools[" in t:
        return "firefunction-v2"
    if ">>>all" in t or ">>>{{" in t:
        return "functionary-v3.2"
    if "<function=" in t and "<|python_tag|>" in t:
        return "functionary-v3.1"
    if "<TOOLCALL>" in t:
        return "nemotron-v2"
    if "<|tools_prefix|>" in t:
        return "apertus"
    if "<|tool_call_start|>" in t:
        return "lfm2"
    if "<minimax:tool_call>" in t:
        return "minimax-m2"
    if "<seed:tool_call>" in t:
        return "seed-oss"
    if "<|tool_calls_section_begin|>" in t:
        return "kimi-k2"
    if "<arg_key>" in t:
        return "glm-4.5"
    if "<function=" in t and "<parameter=" in t:
        return "qwen3-coder"
    if "[THINK]" in t:
        return "magistral"
    if "<tool_call>" in t:
        return "hermes"
    if "[TOOL_CALLS]" in t:
        return "mistral"
    return "auto"
