"""Anthropic Messages API adapter (server parity with the reference's
/v1/messages endpoint — tools/server/server.cpp:169-170, conversion in
tools/server/server-common.cpp convert_anthropic_to_oai and response
shaping in tools/server/server-task.cpp to_json_anthropic[_stream]).

The strategy mirrors the reference exactly: translate the Anthropic
request body into the internal OpenAI-style chat body, run the normal
chat pipeline, then shape the result (or the SSE stream) back into
Anthropic message / event format.
"""

from __future__ import annotations

import json
import uuid


def convert_anthropic_to_oai(body: dict) -> dict:
    """Anthropic Messages request -> OpenAI chat.completions request
    (server-common.cpp:1079)."""
    oai: dict = {}
    messages: list = []

    system = body.get("system")
    if system is not None:
        if isinstance(system, str):
            sys_text = system
        elif isinstance(system, list):
            sys_text = "".join(
                b.get("text", "") for b in system if b.get("type") == "text"
            )
        else:
            sys_text = ""
        messages.append({"role": "system", "content": sys_text})

    if "messages" not in body:
        raise ValueError("'messages' is required")
    for msg in body["messages"]:
        role = msg.get("role", "")
        if "content" not in msg:
            if role == "assistant":
                continue
            messages.append(msg)
            continue
        content = msg["content"]
        if isinstance(content, str) or not isinstance(content, list):
            messages.append(msg)
            continue

        tool_calls = []
        converted = []
        tool_results = []
        for block in content:
            btype = block.get("type", "")
            if btype == "text":
                converted.append(block)
            elif btype == "image":
                source = block.get("source") or {}
                stype = source.get("type", "")
                if stype == "base64":
                    media_type = source.get("media_type", "image/jpeg")
                    url = f"data:{media_type};base64,{source.get('data', '')}"
                    converted.append(
                        {"type": "image_url", "image_url": {"url": url}}
                    )
                elif stype == "url":
                    converted.append(
                        {"type": "image_url",
                         "image_url": {"url": source.get("url", "")}}
                    )
            elif btype == "tool_use":
                tool_calls.append({
                    "id": block.get("id", ""),
                    "type": "function",
                    "function": {
                        "name": block.get("name", ""),
                        "arguments": json.dumps(block.get("input", {})),
                    },
                })
            elif btype == "tool_result":
                rc = block.get("content")
                if isinstance(rc, str):
                    text = rc
                elif isinstance(rc, list):
                    text = "".join(
                        c.get("text", "") for c in rc if c.get("type") == "text"
                    )
                else:
                    text = ""
                tool_results.append({
                    "role": "tool",
                    "tool_call_id": block.get("tool_use_id", ""),
                    "content": text,
                })
        if converted or tool_calls:
            new_msg: dict = {"role": role}
            if converted:
                new_msg["content"] = converted
            elif tool_calls:
                new_msg["content"] = ""
            if tool_calls:
                new_msg["tool_calls"] = tool_calls
            messages.append(new_msg)
        messages.extend(tool_results)

    oai["messages"] = messages

    tools = body.get("tools")
    if isinstance(tools, list):
        oai["tools"] = [
            {
                "type": "function",
                "function": {
                    "name": t.get("name", ""),
                    "description": t.get("description", ""),
                    "parameters": t.get("input_schema", {}),
                },
            }
            for t in tools
        ]

    tc = body.get("tool_choice")
    if isinstance(tc, dict):
        ttype = tc.get("type", "")
        if ttype == "auto":
            oai["tool_choice"] = "auto"
        elif ttype in ("any", "tool"):
            oai["tool_choice"] = "required"

    if "stop_sequences" in body:
        oai["stop"] = body["stop_sequences"]
    oai["max_tokens"] = body.get("max_tokens", 4096)
    for key in ("temperature", "top_p", "top_k", "stream"):
        if key in body:
            oai[key] = body[key]
    return oai


def anthropic_stop_reason(stop_reason: str, has_tool_calls: bool) -> str:
    """STOP_TYPE -> Anthropic stop_reason (server-task.cpp:770-774)."""
    if stop_reason in ("eos", "stop", "word", "stop_string"):
        return "tool_use" if has_tool_calls else "end_turn"
    return "max_tokens"


def anthropic_final(rid: str, model_name: str, content: str,
                    tool_calls: list, stop_reason: str, stop_word: str,
                    n_prompt: int, n_decoded: int) -> dict:
    """Non-streaming Anthropic message (server-task.cpp to_json_anthropic)."""
    blocks = []
    if content:
        blocks.append({"type": "text", "text": content})
    for call in tool_calls:
        fn = call.get("function", {})
        try:
            args = json.loads(fn.get("arguments", "{}"))
        except (json.JSONDecodeError, TypeError):
            args = {}
        blocks.append({
            "type": "tool_use",
            "id": call.get("id", f"toolu_{uuid.uuid4().hex[:12]}"),
            "name": fn.get("name", ""),
            "input": args,
        })
    return {
        "id": rid,
        "type": "message",
        "role": "assistant",
        "content": blocks,
        "model": model_name,
        "stop_reason": anthropic_stop_reason(stop_reason, bool(tool_calls)),
        "stop_sequence": stop_word or None,
        "usage": {"input_tokens": n_prompt, "output_tokens": n_decoded},
    }


def sse_event(event: str, data: dict) -> bytes:
    return f"event: {event}\ndata: {json.dumps(data)}\n\n".encode()


def anthropic_stream_start(rid: str, model_name: str, n_prompt: int) -> list[bytes]:
    """message_start + text content_block_start events."""
    return [
        sse_event("message_start", {
            "type": "message_start",
            "message": {
                "id": rid, "type": "message", "role": "assistant",
                "content": [], "model": model_name,
                "stop_reason": None, "stop_sequence": None,
                "usage": {"input_tokens": n_prompt, "output_tokens": 0},
            },
        }),
        sse_event("content_block_start", {
            "type": "content_block_start",
            "index": 0,
            "content_block": {"type": "text", "text": ""},
        }),
    ]


def anthropic_stream_delta(piece: str) -> bytes:
    return sse_event("content_block_delta", {
        "type": "content_block_delta",
        "index": 0,
        "delta": {"type": "text_delta", "text": piece},
    })


def anthropic_stream_finish(tool_calls: list, stop_reason: str,
                            stop_word: str, n_decoded: int) -> list[bytes]:
    """content_block_stop(s) + tool_use blocks + message_delta +
    message_stop (server-task.cpp to_json_anthropic_stream)."""
    # block 0 is always the text block (opened unconditionally in
    # anthropic_stream_start), so tool_use blocks start at index 1
    events = [sse_event("content_block_stop",
                        {"type": "content_block_stop", "index": 0})]
    base = 1
    for i, call in enumerate(tool_calls):
        fn = call.get("function", {})
        idx = base + i
        events.append(sse_event("content_block_start", {
            "type": "content_block_start", "index": idx,
            "content_block": {
                "type": "tool_use",
                "id": call.get("id", ""),
                "name": fn.get("name", ""),
                "input": {},
            },
        }))
        events.append(sse_event("content_block_delta", {
            "type": "content_block_delta", "index": idx,
            "delta": {
                "type": "input_json_delta",
                "partial_json": fn.get("arguments", "{}"),
            },
        }))
        events.append(sse_event("content_block_stop",
                                {"type": "content_block_stop", "index": idx}))
    events.append(sse_event("message_delta", {
        "type": "message_delta",
        "delta": {
            "stop_reason": anthropic_stop_reason(stop_reason, bool(tool_calls)),
            "stop_sequence": stop_word or None,
        },
        "usage": {"output_tokens": n_decoded},
    }))
    events.append(sse_event("message_stop", {"type": "message_stop"}))
    return events
