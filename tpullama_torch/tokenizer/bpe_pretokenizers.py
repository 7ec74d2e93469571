"""BPE pre-tokenizer regex tables.

One entry per `tokenizer.ggml.pre` family, mirroring the reference's
switch (src/llama-vocab.cpp:280-445). Where the reference adapted a
regex to work around std::regex limitations, we use the *original*
upstream pattern (noted in its comments) since Python's `regex` module
supports case-insensitive groups, lookahead and \\p classes natively —
this matches the HF tokenizer ground truth the reference was
approximating.
"""

# the GPT-2 pattern (used by many families)
_GPT2 = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)"

_LLAMA3 = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

_QWEN2 = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

_GPT4O = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
    r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
    r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

_TEKKEN = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

_DEFAULT = [
    r"[\p{P}\$\+<=>\^~\|]+",
    _GPT2,
    r"\p{N}+",
    r"[0-9][0-9][0-9]",
]

# pre-type name -> list of regexes applied in sequence
PRE_REGEXES: dict[str, list[str]] = {
    "default": _DEFAULT,
    "llama3": [_LLAMA3],
    "dbrx": [_LLAMA3],
    "smaug": [_LLAMA3],
    "deepseek-llm": [
        "[\r\n]",
        "\\s?[A-Za-z\xb5\xc0-\xd6\xd8-\xf6\xf8-\u01ba\u01bc-\u01bf\u01c4-\u0293\u0295-\u02af\u0370-\u0373\u0376\u0377\u037b-\u037d\u037f\u0386\u0388-\u038a\u038c\u038e-\u03a1\u03a3-\u03f5\u03f7-\u0481\u048a-\u052f\u0531-\u0556\u10a0-\u10c5\u13a0-\u13f5\u13f8-\u13fd\u1c90-\u1cba\u1cbd-\u1cbf\u1d00-\u1d2b\u1d6b-\u1d77\u1d79-\u1d9a\u1e00-\u1f15\u1f18-\u1f1d\u1f20-\u1f45\u1f48-\u1f4d\u1f50-\u1f57\u1f59\u1f5b\u1f5d\u1f5f-\u1f7d\u1f80-\u1fb4\u1fb6-\u1fbc\u1fbe\u1fc2-\u1fc4\u1fc6-\u1fcc\u1fd0-\u1fd3\u1fd6-\u1fdb\u1fe0-\u1fec\u1ff2-\u1ff4\u1ff6-\u1ffc\u2102\u2107\u210a-\u2113\u2115\u2119-\u211d\u2124\u2126\u2128\u212a-\u212d\u212f-\u2134\u2139\u213c-\u213f\u2145-\u2149\u214e\u2183\u2184\u2c00-\u2c7b\u2c7e-\u2ce4\u2ceb-\u2cee\u2cf2\u2cf3\ua640-\ua66d\ua680-\ua69b\ua722-\ua76f\ua771-\ua787\ua78b-\ua78e\uab70-\uabbf\ufb00-\ufb06\ufb13-\ufb17\uff21-\uff3a\uff41-\uff5a\U00010400-\U0001044f\U000104b0-\U000104d3\U000104d8-\U000104fb\U00010c80-\U00010cb2\U00010cc0-\U00010cf2\U000118a0-\U000118df\U0001e900-\U0001e943]+",
        r"\s?[!-/:-~！-／：-～‘-‟　-。]+",
        r"\s+$",
        r"[一-龥ࠀ-一가-퟿]+",
        r"\p{N}+",
    ],
    "deepseek3": [
        r"\p{N}{1,3}",
        r"[一-龥぀-ゟ゠-ヿ]+",
        "[!\"#$%&'()*+,\\-./:;<=>?@\\[\\\\\\]^_`{|}~][A-Za-z]+|[^\r\n\\p{L}\\p{P}\\p{S}]?[\\p{L}\\p{M}]+| ?[\\p{P}\\p{S}]+[\r\n]*|\\s*[\r\n]+|\\s+(?!\\S)|\\s+",
    ],
    "deepseek-coder": [
        "[\r\n]",
        r"\s?\p{L}+",
        r"\s?\p{P}+",
        r"[一-龥ࠀ-一가-퟿]+",
        r"\p{N}",
    ],
    "falcon": [
        r"[\p{P}\$\+<=>\^~\|`]+",
        _GPT2,
        r"[0-9][0-9][0-9]",
    ],
    "starcoder": [r"\p{N}", _GPT2],
    "refact": [r"\p{N}", _GPT2],
    "command-r": [r"\p{N}", _GPT2],
    "smollm": [r"\p{N}", _GPT2],
    "codeshell": [r"\p{N}", _GPT2],
    "exaone": [r"\p{N}", _GPT2],
    "minerva": [r"\p{N}", _GPT2],
    "gpt2": [_GPT2],
    "mpt": [_GPT2],
    "olmo": [_GPT2],
    "jais": [_GPT2],
    "trillion": [_GPT2],
    "stablelm2": [_QWEN2],
    "qwen2": [_QWEN2],
    "hunyuan": [_QWEN2],
    "poro": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "bloom": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "gpt3-finnish": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "chatglm4": [_LLAMA3],
    "viking": [r" ?[^(\s|.,!?…。，、।۔،)]+", r"\p{N}"],
    "tekken": [_TEKKEN],
    "gpt4o": [_GPT4O],
    "minimax-m2": [_GPT4O],
    "seed-coder": [
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1}"
        r"| ?[^\s\p{L}\p{N}\r\n]+|\s*[\r\n]+|\s+(?!\S)|\s+"
    ],
    "grok-2": [
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
        r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ],
}

# gguf `tokenizer.ggml.pre` strings -> canonical pre family
# (src/llama-vocab.cpp:1836-2040 string matching)
PRE_ALIASES: dict[str, str] = {
    "llama3": "llama3",
    "llama-v3": "llama3",
    "llama-bpe": "llama3",
    "falcon3": "llama3",
    "falcon-h1": "llama3",
    "pixtral": "llama3",
    "midm-2.0": "llama3",
    "lfm2": "llama3",
    "deepseek-llm": "deepseek-llm",
    "deepseek-coder": "deepseek-coder",
    "deepseek-v3": "deepseek3",
    "hunyuan-dense": "deepseek3",
    "falcon": "falcon",
    "mpt": "mpt",
    "starcoder": "starcoder",
    "gpt-2": "gpt2",
    "phi-2": "gpt2",
    "jina-es": "gpt2",
    "jina-de": "gpt2",
    "gigachat": "gpt2",
    "jina-v2-es": "gpt2",
    "jina-v2-de": "gpt2",
    "a.x-4.0": "gpt2",
    "mellum": "gpt2",
    "jina-v1-en": "gpt2",
    "jina-v2-code": "gpt2",
    "roberta-bpe": "gpt2",
    "refact": "refact",
    "command-r": "command-r",
    "qwen2": "qwen2",
    "deepseek-r1-qwen": "qwen2",
    "stablelm2": "stablelm2",
    "olmo": "olmo",
    "dbrx": "dbrx",
    "smaug-bpe": "smaug",
    "poro-chat": "poro",
    "glm4": "chatglm4",
    "chatglm-bpe": "chatglm4",
    "viking": "viking",
    "jais": "jais",
    "tekken": "tekken",
    "smollm": "smollm",
    "codeshell": "codeshell",
    "bloom": "bloom",
    "gpt3-finnish": "gpt3-finnish",
    "exaone": "exaone",
    "minerva-7b": "minerva",
    "hunyuan": "hunyuan",
    "gpt-4o": "gpt4o",
    "minimax-m2": "minimax-m2",
    "seed-coder": "seed-coder",
    "grok-2": "grok-2",
    "trillion": "trillion",
}

# pre families that set extra vocab flags on load
PRE_IGNORE_MERGES = {"llama3", "tekken"}
PRE_ADD_BOS = {"llama3", "tekken"}
PRE_CLEAN_SPACES_FALSE = {
    "deepseek-llm",
    "deepseek-coder",
    "deepseek3",
    "command-r",
    "qwen2",
    "poro",
    "viking",
    "tekken",
    "smollm",
    "bloom",
    "gpt3-finnish",
    "gpt4o",
    "minimax-m2",
    "seed-coder",
    "grok-2",
}
