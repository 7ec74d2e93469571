"""Vocabulary + tokenizers (SPM, BPE, WPM).

A from-scratch implementation of the reference's tokenizer semantics
(src/llama-vocab.cpp): the same fragment/special-token partitioning
(:2644), SPM bigram merging with score priority (:110-240), byte-level
BPE with rank priority and pre-tokenizer regex sequences (:279-650), and
detokenization including clean_spaces passes (:3120-3215). Validated
against the reference's golden .inp/.out vectors.
"""

from __future__ import annotations

import enum
import heapq
from dataclasses import dataclass, field
from functools import lru_cache

from .bpe_pretokenizers import (
    PRE_ADD_BOS,
    PRE_ALIASES,
    PRE_CLEAN_SPACES_FALSE,
    PRE_IGNORE_MERGES,
    PRE_REGEXES,
)

TOKEN_NULL = -1
SPM_ESCAPED_SPACE = "▁"  # ▁


def rwkv_unescape(escaped: str) -> bytes:
    r"""llama_unescape_rwkv_token: \t \n \r \xHH and backslash escapes."""
    out = bytearray()
    i = 0
    n = len(escaped)
    while i < n:
        c = escaped[i]
        if c == "\\" and i + 1 < n:
            nxt = escaped[i + 1]
            if nxt == "t":
                out.append(9)
                i += 2
            elif nxt == "n":
                out.append(10)
                i += 2
            elif nxt == "r":
                out.append(13)
                i += 2
            elif nxt == "x" and i + 3 < n + 1:
                out.append(int(escaped[i + 2 : i + 4], 16))
                i += 4
            else:
                out.append(ord(nxt))
                i += 2
        else:
            out += c.encode("utf-8")
            i += 1
    return bytes(out)


class VocabType(enum.Enum):
    NONE = "none"
    SPM = "spm"
    BPE = "bpe"
    WPM = "wpm"
    UGM = "ugm"
    RWKV = "rwkv"
    PLAMO2 = "plamo2"


class TokenAttr(enum.IntFlag):
    """llama_token_attr (include/llama.h:71+)."""

    UNDEFINED = 0
    UNKNOWN = 1 << 0
    UNUSED = 1 << 1
    NORMAL = 1 << 2
    CONTROL = 1 << 3
    USER_DEFINED = 1 << 4
    BYTE = 1 << 5
    NORMALIZED = 1 << 6
    LSTRIP = 1 << 7
    RSTRIP = 1 << 8
    SINGLE_WORD = 1 << 9


# gguf token_type int -> attr (enum llama_token_type)
_TOKEN_TYPE_TO_ATTR = {
    0: TokenAttr.UNDEFINED,
    1: TokenAttr.NORMAL,
    2: TokenAttr.UNKNOWN,
    3: TokenAttr.CONTROL,
    4: TokenAttr.USER_DEFINED,
    5: TokenAttr.UNUSED,
    6: TokenAttr.BYTE,
}


@lru_cache(maxsize=1)
def _byte_to_unicode() -> dict[int, str]:
    """GPT-2 byte→unicode-char mapping (unicode_byte_to_utf8)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@lru_cache(maxsize=1)
def _unicode_to_byte() -> dict[str, int]:
    return {v: k for k, v in _byte_to_unicode().items()}


def byte_encode(raw: bytes) -> str:
    m = _byte_to_unicode()
    return "".join(m[b] for b in raw)


def byte_decode(text: str) -> bytes:
    m = _unicode_to_byte()
    out = bytearray()
    for ch in text:
        b = m.get(ch)
        if b is None:
            out.extend(ch.encode("utf-8"))
        else:
            out.append(b)
    return bytes(out)


@dataclass
class TokenData:
    text: str
    score: float
    attr: TokenAttr


@dataclass
class _Fragment:
    # either raw text or a resolved special token
    token: int = TOKEN_NULL
    text: str = ""


class Vocab:
    """Loaded vocabulary with tokenize/detokenize.

    Construct with `Vocab.from_gguf(reader)` or directly for tests.
    """

    def __init__(
        self,
        vocab_type: VocabType,
        tokens: list[TokenData],
        *,
        merges: list[str] | None = None,
        pre: str = "default",
        bos_id: int = TOKEN_NULL,
        eos_id: int = TOKEN_NULL,
        eot_id: int = TOKEN_NULL,
        eom_id: int = TOKEN_NULL,
        unk_id: int = TOKEN_NULL,
        sep_id: int = TOKEN_NULL,
        pad_id: int = TOKEN_NULL,
        mask_id: int = TOKEN_NULL,
        add_bos: bool = False,
        add_eos: bool = False,
        add_sep: bool = False,
        add_space_prefix: bool = False,
        remove_extra_whitespaces: bool = False,
        escape_whitespaces: bool = True,
        treat_whitespace_as_suffix: bool = False,
        clean_spaces: bool = False,
        ignore_merges: bool = False,
    ):
        self.type = vocab_type
        self.id_to_token = tokens
        self.token_to_id = {t.text: i for i, t in enumerate(tokens)}
        self.pre = pre
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.eot_id = eot_id
        self.eom_id = eom_id
        self.unk_id = unk_id
        self.sep_id = sep_id
        self.pad_id = pad_id
        self.mask_id = mask_id
        self.add_bos = add_bos
        self.add_eos = add_eos
        self.add_sep = add_sep
        self.add_space_prefix = add_space_prefix
        self.remove_extra_whitespaces = remove_extra_whitespaces
        self.escape_whitespaces = escape_whitespaces
        self.treat_whitespace_as_suffix = treat_whitespace_as_suffix
        self.clean_spaces = clean_spaces
        self.ignore_merges = ignore_merges

        self.precompiled_charsmap: bytes | None = None
        self._ugm = None
        self._rwkv_trie = None
        self._plamo2 = None
        self._rwkv_pieces = None
        self.bpe_ranks: dict[tuple[str, str], int] = {}
        if merges is not None and len(merges):
            for i, m in enumerate(merges):
                pos = m.find(" ", 1)
                if pos > 0:
                    self.bpe_ranks[(m[:pos], m[pos + 1 :])] = i

        # special tokens cache: CONTROL|USER_DEFINED|UNKNOWN, longest first
        # (llama-vocab.cpp:2438-2450)
        self._special_ids = sorted(
            (
                i
                for i, t in enumerate(tokens)
                if t.attr & (TokenAttr.CONTROL | TokenAttr.USER_DEFINED | TokenAttr.UNKNOWN)
            ),
            key=lambda i: -len(tokens[i].text),
        )

        if self.type == VocabType.BPE:
            # `regex` (unicode property classes) is needed by BPE vocabs
            # only; SPM and WPM vocabs load without it
            import regex as _regex

            family = PRE_ALIASES.get(pre, "default")
            self._regexes = [_regex.compile(r) for r in PRE_REGEXES[family]]
        else:
            self._regexes = []

        self.eog_ids = {
            t for t in (self.eos_id, self.eot_id, self.eom_id) if t != TOKEN_NULL
        }
        for i, t in enumerate(tokens):
            if t.text in ("<|eot_id|>", "<|im_end|>", "<|end|>", "<end_of_turn>",
                          "<|endoftext|>", "<EOT>", "_<EOT>", "<|end_of_text|>"):
                self.eog_ids.add(i)

        # FIM token detection by text (llama-vocab.cpp:2225-2340); GGUF-keyed
        # overrides applied by from_gguf after construction
        _FIM_TEXTS = {
            "fim_pre_id": ("<|fim_prefix|>", "<fim-prefix>", "<fim_prefix>",
                           "<｜fim▁begin｜>", "<PRE>", "▁<PRE>", "<|code_prefix|>"),
            "fim_suf_id": ("<|fim_suffix|>", "<fim-suffix>", "<fim_suffix>",
                           "<｜fim▁hole｜>", "<SUF>", "▁<SUF>", "<|code_suffix|>"),
            "fim_mid_id": ("<|fim_middle|>", "<fim-middle>", "<fim_middle>",
                           "<｜fim▁end｜>", "<MID>", "▁<MID>", "<|code_middle|>"),
            "fim_pad_id": ("<|fim_pad|>", "<fim-pad>", "<fim_pad>", "<PAD>"),
            "fim_rep_id": ("<|fim_repo|>", "<|repo_name|>", "<fim-repo>",
                           "<REPO>", "<reponame>"),
            "fim_sep_id": ("<|file_sep|>", "<|fim_file_separator|>"),
        }
        for attr_name, texts in _FIM_TEXTS.items():
            tid = TOKEN_NULL
            for txt in texts:
                if txt in self.token_to_id:
                    tid = self.token_to_id[txt]
                    break
            setattr(self, attr_name, tid)

    # ------------------------------------------------------------------ load

    @classmethod
    def from_gguf(cls, reader) -> "Vocab":
        kv = reader.kv
        model = kv.get("tokenizer.ggml.model", "llama")
        pre = kv.get("tokenizer.ggml.pre", "")
        tokens_text = kv.get("tokenizer.ggml.tokens", [])
        scores = kv.get("tokenizer.ggml.scores")
        token_types = kv.get("tokenizer.ggml.token_type")
        n = len(tokens_text)
        tokens = []
        for i in range(n):
            score = float(scores[i]) if scores is not None and i < len(scores) else 0.0
            tt = int(token_types[i]) if token_types is not None and i < len(token_types) else 1
            attr = _TOKEN_TYPE_TO_ATTR.get(tt, TokenAttr.UNDEFINED)
            tokens.append(TokenData(tokens_text[i], score, attr))

        # per-family defaults (src/llama-vocab.cpp:1714-1840)
        if model == "llama":
            vtype = VocabType.SPM
            defaults = dict(
                bos_id=1, eos_id=2, unk_id=0,
                add_bos=True, add_eos=False, add_space_prefix=True,
                clean_spaces=False,
            )
        elif model == "gpt2":
            vtype = VocabType.BPE
            defaults = dict(
                bos_id=11, eos_id=11,
                add_bos=False, add_eos=False, add_space_prefix=False,
                clean_spaces=True,
            )
        elif model == "bert":
            vtype = VocabType.WPM
            defaults = dict(
                bos_id=101, unk_id=100, sep_id=102, pad_id=0,
                add_sep=True, add_bos=True, add_eos=False,
                clean_spaces=True,
            )
        elif model == "t5":
            vtype = VocabType.UGM
            defaults = dict(
                bos_id=TOKEN_NULL, eos_id=1, unk_id=2, pad_id=0,
                add_bos=False, add_eos=True, add_space_prefix=True,
                remove_extra_whitespaces=False,
            )
        elif model == "rwkv":
            vtype = VocabType.RWKV
            defaults = dict(
                add_bos=False, add_eos=False, add_space_prefix=False,
                clean_spaces=False,
            )
        elif model == "plamo2":
            # Aho–Corasick + DP segmentation (llama-vocab.cpp:1810-1819)
            vtype = VocabType.PLAMO2
            defaults = dict(
                bos_id=1, eos_id=2, unk_id=0, pad_id=3,
                add_bos=False, add_eos=False, add_space_prefix=False,
                clean_spaces=False,
            )
        elif model in ("none", "no_vocab"):
            vtype = VocabType.NONE
            defaults = {}
        else:
            raise NotImplementedError(f"tokenizer model {model!r} not supported yet")

        family = PRE_ALIASES.get(pre, "default")
        if vtype == VocabType.BPE:
            if family in PRE_IGNORE_MERGES:
                defaults["ignore_merges"] = True
            if family in PRE_ADD_BOS:
                defaults["add_bos"] = True
            if family in PRE_CLEAN_SPACES_FALSE:
                defaults["clean_spaces"] = False

        # KV overrides
        def ovr(key, name):
            if key in kv:
                defaults[name] = kv[key]

        ovr("tokenizer.ggml.bos_token_id", "bos_id")
        ovr("tokenizer.ggml.eos_token_id", "eos_id")
        ovr("tokenizer.ggml.eot_token_id", "eot_id")
        ovr("tokenizer.ggml.eom_token_id", "eom_id")
        ovr("tokenizer.ggml.unknown_token_id", "unk_id")
        ovr("tokenizer.ggml.seperator_token_id", "sep_id")
        ovr("tokenizer.ggml.padding_token_id", "pad_id")
        ovr("tokenizer.ggml.mask_token_id", "mask_id")
        ovr("tokenizer.ggml.add_bos_token", "add_bos")
        ovr("tokenizer.ggml.add_eos_token", "add_eos")
        ovr("tokenizer.ggml.add_sep_token", "add_sep")
        ovr("tokenizer.ggml.add_space_prefix", "add_space_prefix")
        ovr("tokenizer.ggml.remove_extra_whitespaces", "remove_extra_whitespaces")

        for k in ("bos_id", "eos_id", "eot_id", "eom_id", "unk_id", "sep_id", "pad_id",
                  "mask_id"):
            if k in defaults and defaults[k] is not None:
                defaults[k] = int(defaults[k])

        vocab = cls(
            vtype,
            tokens,
            merges=kv.get("tokenizer.ggml.merges"),
            pre=pre,
            **defaults,
        )

        # FIM id overrides from GGUF keys (llama-vocab.cpp:2139-2149).
        # Explicit keys take precedence over the text-based detection that
        # ran in __init__ (the reference reads keys first, then text-detects
        # only the still-null ids).
        for key, attr in (
            ("tokenizer.ggml.fim_pre_token_id", "fim_pre_id"),
            ("tokenizer.ggml.fim_suf_token_id", "fim_suf_id"),
            ("tokenizer.ggml.fim_mid_token_id", "fim_mid_id"),
            ("tokenizer.ggml.fim_pad_token_id", "fim_pad_id"),
            ("tokenizer.ggml.fim_rep_token_id", "fim_rep_id"),
            ("tokenizer.ggml.fim_sep_token_id", "fim_sep_id"),
            # legacy aliases (only fill if still unset)
            ("tokenizer.ggml.prefix_token_id", "fim_pre_id"),
            ("tokenizer.ggml.suffix_token_id", "fim_suf_id"),
            ("tokenizer.ggml.middle_token_id", "fim_mid_id"),
        ):
            if key in kv and (
                key.startswith("tokenizer.ggml.fim_")
                or getattr(vocab, attr) == TOKEN_NULL
            ):
                setattr(vocab, attr, int(kv[key]))

        pc = kv.get("tokenizer.ggml.precompiled_charsmap")
        if pc is not None:
            import numpy as _np

            vocab.precompiled_charsmap = bytes(_np.asarray(pc, dtype=_np.uint8))

        # model-specific attr fixups (llama-vocab.cpp:2509-2530)
        name = str(kv.get("general.name", "")).lower()
        if "phi-3" in name or "phi3" in name:
            for i in vocab._special_ids:
                tokens[i].attr |= TokenAttr.RSTRIP
            if "</s>" in vocab.token_to_id:
                tokens[vocab.token_to_id["</s>"]].attr |= TokenAttr.RSTRIP
            for t in ("<unk>", "<s>", "<|endoftext|>"):
                if t in vocab.token_to_id:
                    tokens[vocab.token_to_id[t]].attr &= ~TokenAttr.RSTRIP
        return vocab

    # ------------------------------------------------------------- helpers

    @property
    def n_tokens(self) -> int:
        return len(self.id_to_token)

    def text_to_token(self, text: str) -> int:
        return self.token_to_id.get(text, TOKEN_NULL)

    def byte_to_token(self, b: int) -> int:
        if self.type in (VocabType.SPM, VocabType.UGM):
            tok = self.token_to_id.get(f"<0x{b:02X}>")
            if tok is not None:
                return tok
            return self.token_to_id[chr(b)]
        # BPE/WPM: byte-encoded single char
        return self.token_to_id[_byte_to_unicode()[b]]

    def is_eog(self, token: int) -> bool:
        return token in self.eog_ids

    # ------------------------------------------- special token partition

    def _partition_specials(self, text: str, parse_special: bool) -> list[_Fragment]:
        """tokenizer_st_partition (llama-vocab.cpp:2644-2760)."""
        fragments = [_Fragment(text=text)] if text else []
        for sid in self._special_ids:
            data = self.id_to_token[sid]
            if not parse_special and data.attr & (TokenAttr.CONTROL | TokenAttr.UNKNOWN):
                continue
            stext = data.text
            if not stext:
                continue
            out: list[_Fragment] = []
            for frag in fragments:
                if frag.token != TOKEN_NULL:
                    out.append(frag)
                    continue
                rest = frag.text
                while rest:
                    idx = rest.find(stext)
                    if idx < 0:
                        out.append(_Fragment(text=rest))
                        break
                    left = rest[:idx]
                    if data.attr & TokenAttr.LSTRIP:
                        left = left.rstrip(" \t\n\r\x0b\x0c")
                    if left:
                        out.append(_Fragment(text=left))
                    out.append(_Fragment(token=sid))
                    rest = rest[idx + len(stext) :]
                    if data.attr & TokenAttr.RSTRIP:
                        rest = rest.lstrip(" \t\n\r\x0b\x0c")
            fragments = out
        return fragments

    # ------------------------------------------------------------ tokenize

    def tokenize(self, text: str, add_special: bool = True, parse_special: bool = True) -> list[int]:
        fragments = self._partition_specials(text, parse_special)
        output: list[int] = []

        if self.type == VocabType.SPM:
            is_prev_special = True  # prefix space for the first fragment
            if add_special and self.add_bos:
                output.append(self.bos_id)
                is_prev_special = True
            for frag in fragments:
                if frag.token != TOKEN_NULL:
                    output.append(frag.token)
                    is_prev_special = True
                    continue
                t = frag.text
                if self.add_space_prefix and is_prev_special:
                    t = " " + t
                t = t.replace(" ", SPM_ESCAPED_SPACE)
                self._spm_tokenize(t, output)
                is_prev_special = False
            if add_special and self.add_eos:
                output.append(self.eos_id)
        elif self.type == VocabType.BPE:
            if add_special and self.add_bos:
                output.append(self.bos_id)
            for frag in fragments:
                if frag.token != TOKEN_NULL:
                    output.append(frag.token)
                else:
                    self._bpe_tokenize(frag.text, output)
            if add_special and self.add_eos:
                output.append(self.eos_id)
        elif self.type == VocabType.UGM:
            # llama-vocab.cpp:2926-2960: no BOS by default, EOS appended
            if add_special and self.add_bos and self.bos_id != TOKEN_NULL:
                output.append(self.bos_id)
            if self._ugm is None:
                from .ugm import UgmTokenizer

                self._ugm = UgmTokenizer(self, self.precompiled_charsmap)
            for frag in fragments:
                if frag.token != TOKEN_NULL:
                    output.append(frag.token)
                else:
                    output.extend(self._ugm.tokenize(frag.text))
            if add_special and self.add_eos:
                output.append(self.eos_id)
        elif self.type == VocabType.RWKV:
            # greedy longest-match over raw bytes (llm_tokenizer_rwkv)
            if self._rwkv_trie is None:
                from .ugm import _Trie

                self._rwkv_trie = _Trie()
                self._rwkv_pieces = [rwkv_unescape(td.text) for td in self.id_to_token]
                for tid, raw in enumerate(self._rwkv_pieces):
                    if raw:
                        self._rwkv_trie.insert(raw, tid)
            for frag in fragments:
                if frag.token != TOKEN_NULL:
                    output.append(frag.token)
                    continue
                data = frag.text.encode("utf-8")
                pos = 0
                while pos < len(data):
                    node = self._rwkv_trie.children.get(data[pos])
                    token_id, token_end = TOKEN_NULL, 0
                    p = pos + 1
                    while node is not None:
                        if node.value is not None:
                            token_id, token_end = node.value, p
                        node = node.children.get(data[p]) if p < len(data) else None
                        p += 1
                    if token_end == 0:
                        output.append(self.unk_id)
                        pos += 1
                    else:
                        output.append(token_id)
                        pos = token_end
        elif self.type == VocabType.WPM:
            if add_special:
                output.append(self.bos_id)
            for frag in fragments:
                if frag.token != TOKEN_NULL:
                    output.append(frag.token)
                else:
                    self._wpm_tokenize(frag.text, output)
            if add_special:
                output.append(self.sep_id)
        elif self.type == VocabType.PLAMO2:
            # llama-vocab.cpp:2975-2995: optional BOS/EOS around the
            # suffix-automaton DP segmentation
            if add_special and self.add_bos:
                output.append(self.bos_id)
            if self._plamo2 is None:
                from .plamo2 import Plamo2Tokenizer

                self._plamo2 = Plamo2Tokenizer(self)
            for frag in fragments:
                if frag.token != TOKEN_NULL:
                    output.append(frag.token)
                else:
                    output.extend(self._plamo2.encode(frag.text))
            if add_special and self.add_eos:
                output.append(self.eos_id)
        else:
            raise NotImplementedError(f"tokenize: vocab type {self.type}")
        return output

    # SPM: greedy bigram merge by score (llama-vocab.cpp:110-240)
    def _spm_tokenize(self, text: str, output: list[int]):
        if not text:
            return
        # symbols over utf-8 *bytes* grouped into chars
        raw = text.encode("utf-8")
        sym_text: list[bytes] = []
        i = 0
        while i < len(raw):
            b = raw[i]
            ln = 1 if b < 0x80 else (2 if b >> 5 == 0b110 else (3 if b >> 4 == 0b1110 else (4 if b >> 3 == 0b11110 else 1)))
            ln = min(ln, len(raw) - i)
            sym_text.append(raw[i : i + ln])
            i += ln
        n = len(sym_text)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        size = [len(s) for s in sym_text]  # 0 when merged away
        rev_merge: dict[bytes, tuple[int, int]] = {}
        heap: list[tuple[float, int, int, int]] = []

        def try_add(left: int, right: int):
            if left == -1 or right == -1:
                return
            merged = sym_text[left] + sym_text[right]
            try:
                s = merged.decode("utf-8")
            except UnicodeDecodeError:
                return
            tok = self.token_to_id.get(s, TOKEN_NULL)
            if tok == TOKEN_NULL or tok >= self.n_tokens:
                return
            score = self.id_to_token[tok].score
            heapq.heappush(heap, (-score, left, right, len(merged)))
            rev_merge[merged] = (left, right)

        for i in range(1, n):
            try_add(i - 1, i)
        while heap:
            nscore, left, right, bsize = heapq.heappop(heap)
            if size[left] == 0 or size[right] == 0 or size[left] + size[right] != bsize:
                continue
            sym_text[left] = sym_text[left] + sym_text[right]
            size[left] += size[right]
            size[right] = 0
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            try_add(prev[left], left)
            try_add(left, nxt[left])

        def resegment(idx: int):
            bs = sym_text[idx]
            try:
                s = bs.decode("utf-8")
            except UnicodeDecodeError:
                s = None
            tok = self.token_to_id.get(s, TOKEN_NULL) if s is not None else TOKEN_NULL
            if tok != TOKEN_NULL:
                output.append(tok)
                return
            p = rev_merge.get(bs)
            if p is None:
                for byte in bs:
                    output.append(self.byte_to_token(byte))
                return
            resegment(p[0])
            resegment(p[1])

        i = 0
        while i != -1:
            resegment(i)
            i = nxt[i]

    # BPE: regex pre-tokenize + byte encoding + rank merge (:430-650)
    def _bpe_tokenize(self, text: str, output: list[int]):
        words = self._pretokenize(text)
        for word in words:
            if not word:
                continue
            if self.ignore_merges and word in self.token_to_id:
                output.append(self.token_to_id[word])
                continue
            symbols = list(word)
            n = len(symbols)
            prev = list(range(-1, n - 1))
            nxt = list(range(1, n + 1))
            if n:
                nxt[-1] = -1
            alive = [True] * n
            heap: list[tuple[int, int, int, int, str]] = []
            seq = 0

            def try_add(left: int, right: int):
                nonlocal seq
                if left == -1 or right == -1:
                    return
                rank = self.bpe_ranks.get((symbols[left], symbols[right]))
                if rank is None:
                    return
                heapq.heappush(heap, (rank, left, seq, right, symbols[left] + symbols[right]))
                seq += 1

            for i in range(1, n):
                try_add(i - 1, i)
            while heap:
                rank, left, _, right, btext = heapq.heappop(heap)
                if not alive[left] or not alive[right]:
                    continue
                if symbols[left] + symbols[right] != btext:
                    continue
                symbols[left] = symbols[left] + symbols[right]
                alive[right] = False
                symbols[right] = ""
                nxt[left] = nxt[right]
                if nxt[right] >= 0:
                    prev[nxt[right]] = left
                try_add(prev[left], left)
                try_add(left, nxt[left])

            i = 0
            while i != -1 and n:
                if alive[i]:
                    s = symbols[i]
                    tok = self.token_to_id.get(s, TOKEN_NULL)
                    if tok == TOKEN_NULL:
                        for ch in s:
                            t2 = self.token_to_id.get(ch, TOKEN_NULL)
                            if t2 != TOKEN_NULL:
                                output.append(t2)
                    else:
                        output.append(tok)
                i = nxt[i]

    def _pretokenize(self, text: str) -> list[str]:
        """Sequential regex splitting (unicode_regex_split semantics,
        src/unicode.cpp:959-1137): each regex re-partitions every current
        span — its matches and the gaps between them all become spans for
        the next regex. Finally GPT-2 byte encoding."""
        spans: list[str] = [text]
        for rx in self._regexes:
            out: list[str] = []
            for span in spans:
                pos = 0
                for m in rx.finditer(span):
                    if m.start() > pos:
                        out.append(span[pos : m.start()])
                    if m.group():
                        out.append(m.group())
                    pos = m.end()
                if pos < len(span):
                    out.append(span[pos:])
            spans = out
        return [byte_encode(s.encode("utf-8")) for s in spans]

    # WPM (llama-vocab.cpp:656-770): NFD + lowercase, isolate punctuation/
    # ascii-symbols/CJK, then longest-match with phantom ▁; whole word → UNK
    # if any position fails to match
    def _wpm_tokenize(self, text: str, output: list[int]):
        import unicodedata

        words: list[str] = [""]
        for ch in unicodedata.normalize("NFD", text):
            cp = ord(ch)
            cat = unicodedata.category(ch)
            if cat == "Mn":
                # the reference's NFD table keeps only base chars
                # (unicode_cpts_normalize_nfd maps cpt -> single base cpt)
                continue
            if ch.isspace() or cat.startswith("Z"):
                if words[-1]:
                    words.append("")
                continue
            if cp == 0 or cp == 0xFFFD or cat in ("Cc", "Cf"):
                continue
            s = ch.lower()
            is_cjk = (
                0x4E00 <= cp <= 0x9FFF
                or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF
                or 0x2A700 <= cp <= 0x2B73F
                or 0x2B740 <= cp <= 0x2B81F
                or 0x2B920 <= cp <= 0x2CEAF
                or 0xF900 <= cp <= 0xFAFF
                or 0x2F800 <= cp <= 0x2FA1F
            )
            if cat.startswith("P") or (cp < 0x7F and cat.startswith("S")) or is_cjk:
                if words[-1]:
                    words.append("")
                words[-1] = s
                words.append("")
            else:
                words[-1] += s
        if words and not words[-1]:
            words.pop()

        # llama.cpp matches over utf-8 *bytes* of "▁"+word
        max_len = max((len(t.text.encode("utf-8")) for t in self.id_to_token), default=0)
        for word in words:
            if not word:
                continue
            w = (SPM_ESCAPED_SPACE + word).encode("utf-8")
            n = len(w)
            start_out = len(output)
            i = 0
            ok = True
            while i < n:
                match = False
                for j in range(min(n, i + max_len + 1), i, -1):
                    try:
                        cand = w[i:j].decode("utf-8")
                    except UnicodeDecodeError:
                        continue
                    tok = self.token_to_id.get(cand, TOKEN_NULL)
                    if tok != TOKEN_NULL:
                        output.append(tok)
                        i = j
                        match = True
                        break
                if not match:
                    del output[start_out:]
                    ok = False
                    break
            if not ok or len(output) == start_out:
                output.append(self.unk_id)

    # ---------------------------------------------------------- detokenize

    def token_to_piece(self, token: int, special: bool = True, lstrip: int = 0) -> str:
        """llama_vocab::token_to_piece (:2999-3105)."""
        if not (0 <= token < self.n_tokens):
            return ""
        data = self.id_to_token[token]
        attr_special = TokenAttr.UNKNOWN | TokenAttr.CONTROL
        if not special and data.attr & attr_special:
            return ""
        if self.type in (VocabType.SPM, VocabType.UGM, VocabType.WPM):
            if data.attr & (attr_special | TokenAttr.USER_DEFINED):
                piece = data.text
            elif data.attr & TokenAttr.NORMAL:
                piece = data.text.replace(SPM_ESCAPED_SPACE, " ")
            elif data.attr & TokenAttr.BYTE:
                t = data.text
                piece = chr(int(t[3:5], 16)) if t.startswith("<0x") else t
            else:
                piece = ""
        elif self.type == VocabType.BPE:
            if data.attr & (attr_special | TokenAttr.USER_DEFINED):
                piece = data.text
            elif data.attr & TokenAttr.NORMAL:
                piece = byte_decode(data.text).decode("utf-8", errors="replace")
            else:
                piece = ""
        elif self.type == VocabType.PLAMO2:
            # byte tokens emit the raw byte; everything else is literal
            # text (llama-vocab.cpp:3080-3097)
            t = data.text
            if data.attr & TokenAttr.BYTE and t.startswith("<0x"):
                piece = chr(int(t[3:5], 16))
            else:
                piece = t
        else:
            piece = data.text
        for _ in range(lstrip):
            if piece.startswith(" "):
                piece = piece[1:]
        return piece

    def detokenize(
        self, tokens: list[int], remove_special: bool = False, unparse_special: bool = False
    ) -> str:
        """llama_vocab::detokenize (:3117-3215)."""
        toks = list(tokens)
        remove_space = self.add_space_prefix
        if remove_special and self.add_bos and toks and toks[0] == self.bos_id:
            remove_space = False
            toks = toks[1:]
        if remove_special and self.add_eos and toks and toks[-1] == self.eos_id:
            toks = toks[:-1]
        # reassemble at BYTE level: byte-fallback tokens each carry one
        # raw UTF-8 byte (chr(b) at the piece level), and a multi-byte
        # character split across byte tokens only recombines correctly
        # when concatenated as bytes (the C path works on char buffers)
        buf = bytearray()
        for t in toks:
            piece = self.token_to_piece(
                t, special=unparse_special, lstrip=1 if remove_space else 0
            )
            remove_space = False
            data = self.id_to_token[t] if 0 <= t < self.n_tokens else None
            if (
                data is not None
                and data.attr & TokenAttr.BYTE
                and data.text.startswith("<0x")
                and len(piece) == 1
            ):
                buf.append(ord(piece))
            else:
                buf.extend(piece.encode("utf-8"))
        text = buf.decode("utf-8", errors="replace")
        if self.clean_spaces:
            # pass 1: drop space before ?!.,
            out = []
            for ch in text:
                if out and out[-1] == " " and ch in "?!.,":
                    out.pop()
                out.append(ch)
            # pass 2: " ' " -> "'"
            text = "".join(out)
            out = []
            i = 0
            while i < len(text):
                if (
                    text[i] == "'"
                    and i > 0
                    and i + 1 < len(text)
                    and out
                    and out[-1] == " "
                    and text[i + 1] == " "
                ):
                    out.pop()
                    out.append("'")
                    i += 2
                    continue
                out.append(text[i])
                i += 1
            # pass 3: contractions " 's", " 'm", " 're", " 've"
            text = "".join(out)
            out = []
            i = 0
            while i < len(text):
                if text[i] == "'" and out and out[-1] == " " and i + 1 < len(text):
                    nxt1 = text[i + 1]
                    nxt2 = text[i + 2] if i + 2 < len(text) else ""
                    if nxt1 in ("s", "m") or (nxt1 == "r" and nxt2 == "e") or (
                        nxt1 == "v" and nxt2 == "e"
                    ):
                        out.pop()
                out.append(text[i])
                i += 1
            text = "".join(out)
        return text
