"""Builtin (hardcoded) chat-template dialects.

Mirrors src/llama-chat.cpp: the named-template registry
(LLM_CHAT_TEMPLATES, llama-chat.cpp:31-80), the substring detection
heuristics (llm_chat_detect_template, llama-chat.cpp:82-222) and the
per-dialect formatters (llm_chat_apply_template, llama-chat.cpp:230-850).

These are the fallback path when a GGUF carries no jinja
tokenizer.chat_template (or the jinja render fails), and the target of
the server's --chat-template <name> override. Golden outputs are
verified against tests/test-chat-template.cpp expected strings in
tests/test_chat_templates.py.
"""

from __future__ import annotations


def _trim(s: str) -> str:
    return s.strip()


def _msgs(messages: list) -> list[tuple[str, str]]:
    return [(str(m.get("role", "")), str(m.get("content") or "")) for m in messages]


# ---------------------------------------------------------------------------
# per-dialect formatters
# ---------------------------------------------------------------------------

def _apply_chatml(ms, add_ass):
    out = [f"<|im_start|>{r}\n{c}<|im_end|>\n" for r, c in ms]
    if add_ass:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _apply_mistral_v7(ms, add_ass, tekken=False):
    ts = "" if tekken else " "
    out = []
    for r, c in ms:
        if r == "system":
            out.append(f"[SYSTEM_PROMPT]{ts}{c}[/SYSTEM_PROMPT]")
        elif r == "user":
            out.append(f"[INST]{ts}{c}[/INST]")
        else:
            out.append(f"{ts}{c}</s>")
    return "".join(out)


def _apply_mistral_v1v3(ms, add_ass, variant):
    ls = " " if variant == "v1" else ""
    ts = "" if variant == "v3-tekken" else " "
    trim_ass = variant == "v3"
    out = []
    inside = False
    for r, c in ms:
        if not inside:
            out.append(f"{ls}[INST]{ts}")
            inside = True
        if r == "system":
            out.append(c + "\n\n")
        elif r == "user":
            out.append(f"{c}{ls}[/INST]")
        else:
            out.append(f"{ts}{_trim(c) if trim_ass else c}</s>")
            inside = False
    return "".join(out)


def _apply_llama2(ms, add_ass, support_system=False, bos_in_history=False,
                  strip=False):
    out = ["[INST] "]
    inside = True  # skip BOS at the beginning
    for r, c in ms:
        if strip:
            c = _trim(c)
        if not inside:
            inside = True
            out.append("<s>[INST] " if bos_in_history else "[INST] ")
        if r == "system":
            if support_system:
                out.append(f"<<SYS>>\n{c}\n<</SYS>>\n\n")
            else:
                out.append(c + "\n")
        elif r == "user":
            out.append(f"{c} [/INST]")
        else:
            out.append(f"{c}</s>")
            inside = False
    return "".join(out)


def _apply_phi3(ms, add_ass):
    out = [f"<|{r}|>\n{c}<|end|>\n" for r, c in ms]
    if add_ass:
        out.append("<|assistant|>\n")
    return "".join(out)


def _apply_phi4(ms, add_ass):
    out = [f"<|im_start|>{r}<|im_sep|>{c}<|im_end|>" for r, c in ms]
    if add_ass:
        out.append("<|im_start|>assistant<|im_sep|>")
    return "".join(out)


def _apply_falcon3(ms, add_ass):
    out = [f"<|{r}|>\n{c}\n" for r, c in ms]
    if add_ass:
        out.append("<|assistant|>\n")
    return "".join(out)


def _apply_zephyr(ms, add_ass):
    out = [f"<|{r}|>\n{c}<|endoftext|>\n" for r, c in ms]
    if add_ass:
        out.append("<|assistant|>\n")
    return "".join(out)


def _apply_monarch(ms, add_ass):
    out = []
    for i, (r, c) in enumerate(ms):
        bos = "" if i == 0 else "<s>"
        out.append(f"{bos}{r}\n{c}</s>\n")
    if add_ass:
        out.append("<s>assistant\n")
    return "".join(out)


def _apply_gemma(ms, add_ass):
    out = []
    system = ""
    for r, c in ms:
        if r == "system":
            system += _trim(c)
            continue
        r = "model" if r == "assistant" else r
        out.append(f"<start_of_turn>{r}\n")
        if system and r != "model":
            out.append(system + "\n\n")
            system = ""
        out.append(f"{_trim(c)}<end_of_turn>\n")
    if add_ass:
        out.append("<start_of_turn>model\n")
    return "".join(out)


def _apply_orion(ms, add_ass):
    out = []
    system = ""
    for r, c in ms:
        if r == "system":
            system += c
        elif r == "user":
            out.append("Human: ")
            if system:
                out.append(system + "\n\n")
                system = ""
            out.append(f"{c}\n\nAssistant: </s>")
        else:
            out.append(f"{c}</s>")
    return "".join(out)


def _apply_openchat(ms, add_ass):
    out = []
    for r, c in ms:
        if r == "system":
            out.append(f"{c}<|end_of_turn|>")
        else:
            out.append(f"GPT4 Correct {r[:1].upper()}{r[1:]}: {c}<|end_of_turn|>")
    if add_ass:
        out.append("GPT4 Correct Assistant:")
    return "".join(out)


def _apply_vicuna(ms, add_ass, orca=False):
    out = []
    for r, c in ms:
        if r == "system":
            out.append(f"SYSTEM: {c}\n" if orca else f"{c}\n\n")
        elif r == "user":
            out.append(f"USER: {c}\n")
        elif r == "assistant":
            out.append(f"ASSISTANT: {c}</s>\n")
    if add_ass:
        out.append("ASSISTANT:")
    return "".join(out)


def _apply_deepseek(ms, add_ass):
    out = []
    for r, c in ms:
        if r == "system":
            out.append(c)
        elif r == "user":
            out.append(f"### Instruction:\n{c}\n")
        elif r == "assistant":
            out.append(f"### Response:\n{c}\n<|EOT|>\n")
    if add_ass:
        out.append("### Response:\n")
    return "".join(out)


def _apply_command_r(ms, add_ass):
    tok = {"system": "<|SYSTEM_TOKEN|>", "user": "<|USER_TOKEN|>",
           "assistant": "<|CHATBOT_TOKEN|>"}
    out = []
    for r, c in ms:
        if r in tok:
            out.append(f"<|START_OF_TURN_TOKEN|>{tok[r]}{_trim(c)}"
                       "<|END_OF_TURN_TOKEN|>")
    if add_ass:
        out.append("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>")
    return "".join(out)


def _apply_llama3(ms, add_ass):
    out = [f"<|start_header_id|>{r}<|end_header_id|>\n\n{_trim(c)}<|eot_id|>"
           for r, c in ms]
    if add_ass:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _apply_chatglm3(ms, add_ass):
    out = ["[gMASK]sop"]
    out += [f"<|{r}|>\n {c}" for r, c in ms]
    if add_ass:
        out.append("<|assistant|>")
    return "".join(out)


def _apply_chatglm4(ms, add_ass):
    out = ["[gMASK]<sop>"]
    out += [f"<|{r}|>\n{c}" for r, c in ms]
    if add_ass:
        out.append("<|assistant|>\n")
    return "".join(out)


def _apply_glmedge(ms, add_ass):
    out = [f"<|{r}|>\n{c}" for r, c in ms]
    if add_ass:
        out.append("<|assistant|>")
    return "".join(out)


def _apply_minicpm(ms, add_ass):
    out = []
    for r, c in ms:
        if r == "user":
            out.append(f"<用户>{_trim(c)}<AI>")
        else:
            out.append(_trim(c))
    return "".join(out)


def _apply_deepseek2(ms, add_ass):
    out = []
    for r, c in ms:
        if r == "system":
            out.append(c + "\n\n")
        elif r == "user":
            out.append(f"User: {c}\n\n")
        elif r == "assistant":
            out.append(f"Assistant: {c}<｜end▁of▁sentence｜>")
    if add_ass:
        out.append("Assistant:")
    return "".join(out)


def _apply_deepseek3(ms, add_ass):
    out = []
    for r, c in ms:
        if r == "system":
            out.append(c + "\n\n")
        elif r == "user":
            out.append(f"<｜User｜>{c}")
        elif r == "assistant":
            out.append(f"<｜Assistant｜>{c}<｜end▁of▁sentence｜>")
    if add_ass:
        out.append("<｜Assistant｜>")
    return "".join(out)


def _apply_exaone(ms, add_ass, v4=False):
    out = []
    for r, c in ms:
        if r == "system":
            out.append(f"[|system|]{_trim(c)}[|endofturn|]\n")
        elif r == "user":
            out.append(f"[|user|]{_trim(c)}\n")
        elif r == "assistant":
            out.append(f"[|assistant|]{_trim(c)}[|endofturn|]\n")
        elif r == "tool" and v4:
            out.append(f"[|tool|]{_trim(c)}[|endofturn|]\n")
    if add_ass:
        out.append("[|assistant|]")
    return "".join(out)


def _apply_rwkv_world(ms, add_ass):
    out = []
    for i, (r, c) in enumerate(ms):
        if r == "system":
            out.append(f"System: {_trim(c)}\n\n")
        elif r == "user":
            out.append(f"User: {_trim(c)}\n\n")
            if i == len(ms) - 1:
                out.append("Assistant:")
        elif r == "assistant":
            out.append(f"Assistant: {_trim(c)}\n\n")
    return "".join(out)


def _apply_granite(ms, add_ass):
    out = []
    for r, c in ms:
        out.append(f"<|start_of_role|>{r}<|end_of_role|>")
        if r == "assistant_tool_call":
            out.append("<|tool_call|>")
        out.append(f"{c}<|end_of_text|>\n")
    if add_ass:
        out.append("<|start_of_role|>assistant<|end_of_role|>")
    return "".join(out)


def _apply_gigachat(ms, add_ass):
    out = []
    start = 0
    if ms and ms[0][0] == "system":
        out.append(f"<s>{ms[0][1]}<|message_sep|>")
        start = 1
    else:
        out.append("<s>")
    for r, c in ms[start:]:
        if r == "user":
            out.append(f"user<|role_sep|>{c}<|message_sep|>"
                       "available functions<|role_sep|>[]<|message_sep|>")
        elif r == "assistant":
            out.append(f"assistant<|role_sep|>{c}<|message_sep|>")
    if add_ass:
        out.append("assistant<|role_sep|>")
    return "".join(out)


def _apply_megrez(ms, add_ass):
    out = [f"<|role_start|>{r}<|role_end|>{c}<|turn_end|>" for r, c in ms]
    if add_ass:
        out.append("<|role_start|>assistant<|role_end|>")
    return "".join(out)


def _apply_yandex(ms, add_ass):
    out = []
    for r, c in ms:
        if r == "user":
            out.append(f" Пользователь: {c}\n\n")
        elif r == "assistant":
            out.append(f" Ассистент: {c}\n\n")
    if add_ass:
        out.append(" Ассистент:[SEP]")
    return "".join(out)


def _apply_bailing(ms, add_ass, think=False):
    out = []
    for r, c in ms:
        role = "HUMAN" if r == "user" else r.upper()
        out.append(f"<role>{role}</role>{c}")
    if add_ass:
        out.append("<role>ASSISTANT</role>")
        if think:
            out.append("<think>")
    return "".join(out)


def _apply_bailing2(ms, add_ass):
    out = []
    if not (ms and ms[0][0] == "system"):
        out.append("<role>SYSTEM</role>detailed thinking off<|role_end|>")
    for r, c in ms:
        role = "HUMAN" if r == "user" else r.upper()
        out.append(f"<role>{role}</role>{c}<|role_end|>")
    if add_ass:
        out.append("<role>ASSISTANT</role>")
    return "".join(out)


def _apply_llama4(ms, add_ass):
    out = [f"<|header_start|>{r}<|header_end|>\n\n{_trim(c)}<|eot|>"
           for r, c in ms]
    if add_ass:
        out.append("<|header_start|>assistant<|header_end|>\n\n")
    return "".join(out)


def _apply_smolvlm(ms, add_ass):
    out = ["<|im_start|>"]  # BOS-like prefix; content is NOT chatml
    for r, c in ms:
        if r == "system":
            out.append(c + "\n\n")
        elif r == "user":
            out.append(f"User: {c}<end_of_utterance>\n")
        else:
            out.append(f"Assistant: {c}<end_of_utterance>\n")
    if add_ass:
        out.append("Assistant:")
    return "".join(out)


def _apply_dots1(ms, add_ass):
    out = []
    for r, c in ms:
        if r == "system":
            out.append(f"<|system|>{c}<|endofsystem|>")
        elif r == "user":
            out.append(f"<|userprompt|>{c}<|endofuserprompt|>")
        else:
            out.append(f"<|response|>{c}<|endofresponse|>")
    if add_ass:
        out.append("<|response|>")
    return "".join(out)


def _apply_hunyuan_moe(ms, add_ass):
    out = []
    for r, c in ms:
        if r == "system":
            out.append(f"<|startoftext|>{c}<|extra_4|>")
        elif r == "assistant":
            out.append(f"{c}<|eos|>")
        else:
            out.append(f"<|startoftext|>{c}<|extra_0|>")
    return "".join(out)


def _apply_openai_moe(ms, add_ass):
    out = []
    for r, c in ms:
        end = "<|return|>" if r == "assistant" else "<|end|>"
        out.append(f"<|start|>{r}<|message|>{c}{end}")
    if add_ass:
        out.append("<|start|>assistant")
    return "".join(out)


def _apply_hunyuan_dense(ms, add_ass):
    out = []
    for i, (r, c) in enumerate(ms):
        if i == 0 and r == "system":
            out.append(f"{c}<｜hy_place▁holder▁no▁3｜>")
        if r == "assistant":
            out.append(f"<｜hy_Assistant｜>{c}<｜hy_place▁holder▁no▁2｜>")
        elif r == "user":
            out.append(f"<｜hy_User｜>{c}<｜hy_Assistant｜>")
    return "".join(out)


def _apply_kimi_k2(ms, add_ass):
    pre = {"system": "<|im_system|>system<|im_middle|>",
           "user": "<|im_user|>user<|im_middle|>",
           "assistant": "<|im_assistant|>assistant<|im_middle|>",
           "tool": "<|im_system|>tool<|im_middle|>"}
    out = []
    for r, c in ms:
        out.append(pre.get(r, ""))
        out.append(f"{c}<|im_end|>")
    if add_ass:
        out.append("<|im_assistant|>assistant<|im_middle|>")
    return "".join(out)


def _apply_seed_oss(ms, add_ass):
    out = []
    for r, c in ms:
        body = _trim(c) if r == "assistant" else c
        out.append(f"<seed:bos>{r}\n{body}<seed:eos>")
    if add_ass:
        out.append("<seed:bos>assistant\n")
    return "".join(out)


def _apply_grok2(ms, add_ass):
    out = []
    for r, c in ms:
        if r == "system":
            out.append(f"System: {_trim(c)}<|separator|>\n\n")
        elif r == "user":
            out.append(f"Human: {_trim(c)}<|separator|>\n\n")
        elif r == "assistant":
            out.append(f"Assistant: {c}<|separator|>\n\n")
    if add_ass:
        out.append("Assistant:")
    return "".join(out)


def _apply_pangu_embed(ms, add_ass):
    roles = {"system": "系统", "user": "用户", "assistant": "助手",
             "tool": "工具", "function": "方法"}
    out = []
    for i, (r, c) in enumerate(ms):
        if i == 0 and r != "system":
            out.append("[unused9]系统：[unused10]")
        if r in roles:
            out.append(f"[unused9]{roles[r]}：{c}[unused10]")
    if add_ass:
        out.append("[unused9]助手：")
    return "".join(out)


# name -> formatter; mirrors LLM_CHAT_TEMPLATES (llama-chat.cpp:31-80)
_APPLY = {
    "chatml": _apply_chatml,
    "llama2": lambda ms, a: _apply_llama2(ms, a),
    "llama2-sys": lambda ms, a: _apply_llama2(ms, a, support_system=True),
    "llama2-sys-bos": lambda ms, a: _apply_llama2(
        ms, a, support_system=True, bos_in_history=True),
    "llama2-sys-strip": lambda ms, a: _apply_llama2(
        ms, a, support_system=True, strip=True),
    "mistral-v1": lambda ms, a: _apply_mistral_v1v3(ms, a, "v1"),
    "mistral-v3": lambda ms, a: _apply_mistral_v1v3(ms, a, "v3"),
    "mistral-v3-tekken": lambda ms, a: _apply_mistral_v1v3(ms, a, "v3-tekken"),
    "mistral-v7": lambda ms, a: _apply_mistral_v7(ms, a),
    "mistral-v7-tekken": lambda ms, a: _apply_mistral_v7(ms, a, tekken=True),
    "phi3": _apply_phi3,
    "phi4": _apply_phi4,
    "falcon3": _apply_falcon3,
    "zephyr": _apply_zephyr,
    "monarch": _apply_monarch,
    "gemma": _apply_gemma,
    "orion": _apply_orion,
    "openchat": _apply_openchat,
    "vicuna": lambda ms, a: _apply_vicuna(ms, a),
    "vicuna-orca": lambda ms, a: _apply_vicuna(ms, a, orca=True),
    "deepseek": _apply_deepseek,
    "deepseek2": _apply_deepseek2,
    "deepseek3": _apply_deepseek3,
    "command-r": _apply_command_r,
    "llama3": _apply_llama3,
    "chatglm3": _apply_chatglm3,
    "chatglm4": _apply_chatglm4,
    "glmedge": _apply_glmedge,
    "minicpm": _apply_minicpm,
    "exaone3": lambda ms, a: _apply_exaone(ms, a),
    "exaone4": lambda ms, a: _apply_exaone(ms, a, v4=True),
    "rwkv-world": _apply_rwkv_world,
    "granite": _apply_granite,
    "gigachat": _apply_gigachat,
    "megrez": _apply_megrez,
    "yandex": _apply_yandex,
    "bailing": lambda ms, a: _apply_bailing(ms, a),
    "bailing-think": lambda ms, a: _apply_bailing(ms, a, think=True),
    "bailing2": _apply_bailing2,
    "llama4": _apply_llama4,
    "smolvlm": _apply_smolvlm,
    "dots1": _apply_dots1,
    "hunyuan-moe": _apply_hunyuan_moe,
    "gpt-oss": _apply_openai_moe,
    "hunyuan-dense": _apply_hunyuan_dense,
    "kimi-k2": _apply_kimi_k2,
    "seed_oss": _apply_seed_oss,
    "grok-2": _apply_grok2,
    "pangu-embedded": _apply_pangu_embed,
}

BUILTIN_TEMPLATES = sorted(_APPLY)


def apply_builtin_template(name: str, messages: list,
                           add_assistant: bool = True) -> str:
    """Format `messages` with the named builtin dialect
    (llm_chat_apply_template, llama-chat.cpp:230)."""
    fn = _APPLY.get(name)
    if fn is None:
        raise KeyError(f"unknown builtin chat template: {name!r}")
    return fn(_msgs(messages), add_assistant)


def detect_template(tmpl: str) -> str | None:
    """Map a jinja chat-template string (or a builtin name) to a builtin
    dialect name via the reference's substring heuristics
    (llm_chat_detect_template, llama-chat.cpp:82-222)."""
    if tmpl in _APPLY:
        return tmpl
    has = lambda s: s in tmpl  # noqa: E731

    if has("<|im_start|>"):
        if has("<|im_sep|>"):
            return "phi4"
        return "smolvlm" if has("<end_of_utterance>") else "chatml"
    if tmpl.startswith("mistral") or has("[INST]"):
        if has("[SYSTEM_PROMPT]"):
            return "mistral-v7"
        if has("' [INST] ' + system_message") or has("[AVAILABLE_TOOLS]"):
            if has(" [INST]"):
                return "mistral-v1"
            if has('"[INST]"'):
                return "mistral-v3-tekken"
            return "mistral-v3"
        if has("content.strip()"):
            return "llama2-sys-strip"
        if has("bos_token + '[INST]"):
            return "llama2-sys-bos"
        if has("<<SYS>>"):
            return "llama2-sys"
        return "llama2"
    if has("<|assistant|>") and has("<|end|>"):
        return "phi3"
    if has("[gMASK]<sop>"):
        return "chatglm4"
    if has("<|assistant|>") and has("<|user|>"):
        return "falcon3" if has("</s>") else "glmedge"
    if has("<|{{ item['role'] }}|>") and has("<|begin_of_image|>"):
        return "glmedge"
    if has("<|user|>") and has("<|endoftext|>"):
        return "zephyr"
    if has("bos_token + message['role']"):
        return "monarch"
    if has("<start_of_turn>"):
        return "gemma"
    if has("'\\n\\nAssistant: ' + eos_token"):
        return "orion"
    if has("GPT4 Correct "):
        return "openchat"
    if has("USER: ") and has("ASSISTANT: "):
        return "vicuna-orca" if has("SYSTEM: ") else "vicuna"
    if has("### Instruction:") and has("<|EOT|>"):
        return "deepseek"
    if has("<|START_OF_TURN_TOKEN|>") and has("<|USER_TOKEN|>"):
        return "command-r"
    if has("<|start_header_id|>") and has("<|end_header_id|>"):
        return "llama3"
    if has("[gMASK]sop"):
        return "chatglm3"
    if has("<用户>"):
        return "minicpm"
    if has("'Assistant: ' + message['content'] + eos_token"):
        return "deepseek2"
    if has("<｜Assistant｜>") and has("<｜User｜>") and has("<｜end▁of▁sentence｜>"):
        return "deepseek3"
    if has("[|system|]") and has("[|assistant|]") and has("[|endofturn|]"):
        return "exaone4" if has("[|tool|]") else "exaone3"
    if has("rwkv-world") or has("{{- 'User: ' + message['content']|trim + '\\n\\n' -}}"):
        return "rwkv-world"
    if has("<|start_of_role|>"):
        return "granite"
    if has("message['role'] + additional_special_tokens[0] + "
           "message['content'] + additional_special_tokens[1]"):
        return "gigachat"
    if has("<|role_start|>"):
        return "megrez"
    if has(" Ассистент:"):
        return "yandex"
    if has("<role>ASSISTANT</role>") and has("'HUMAN'"):
        return "bailing"
    if has("<role>ASSISTANT</role>") and has('"HUMAN"') and has("<think>"):
        return "bailing-think"
    if has("<role>ASSISTANT</role>") and has("<role>HUMAN</role>") \
            and has("<|role_end|>"):
        return "bailing2"
    if has("<|header_start|>") and has("<|header_end|>"):
        return "llama4"
    if has("<|endofuserprompt|>"):
        return "dots1"
    if has("<|extra_0|>") and has("<|extra_4|>"):
        return "hunyuan-moe"
    if has("<|start|>") and has("<|channel|>"):
        return "gpt-oss"
    if has("<｜hy_Assistant｜>") and has("<｜hy_place▁holder▁no▁3｜>"):
        return "hunyuan-dense"
    if has("<|im_assistant|>assistant<|im_middle|>"):
        return "kimi-k2"
    if has("<seed:bos>"):
        return "seed_oss"
    if has("'Assistant: '  + message['content'] + '<|separator|>"):
        return "grok-2"
    if has("[unused9]系统：[unused10]"):
        return "pangu-embedded"
    return None
