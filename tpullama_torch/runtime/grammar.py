"""GBNF grammar engine: parser + incremental UTF-8 pushdown acceptance.

A from-scratch re-implementation of the reference's grammar machinery
(src/llama-grammar.cpp): the GBNF parser with the same repetition
rewrites (:342-520), the stack-advance/char-match pushdown (:606-860),
candidate rejection with partial-UTF-8 handling (:859-925), and the
sampler integration (apply masks non-conforming tokens, accept advances
stacks; lazy trigger tokens/patterns for tool-call grammars,
llama.h:1266-1276).

Rules are lists of (type, value) element tuples; a stack is a tuple of
(rule_id, elem_idx) positions (the analog of C element pointers).
"""

from __future__ import annotations

import re as _re
from dataclasses import dataclass, field

import numpy as np

# element types (llama.h llama_gretype)
END = 0
ALT = 1
RULE_REF = 2
CHAR = 3
CHAR_NOT = 4
CHAR_RNG_UPPER = 5
CHAR_ALT = 6
CHAR_ANY = 7

MAX_REPETITION_THRESHOLD = 1000


# ---------------------------------------------------------------------------
# UTF-8 incremental decoding (decode_utf8, llama-grammar.cpp:33-90)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PartialUtf8:
    value: int = 0
    n_remain: int = 0


def decode_utf8(piece: bytes, partial_start: PartialUtf8) -> tuple[list[int], PartialUtf8]:
    lookup = [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4]
    value = partial_start.value
    n_remain = partial_start.n_remain
    cps: list[int] = []
    i = 0
    n = len(piece)
    # continue a pending sequence
    while i < n and n_remain > 0:
        b = piece[i]
        if (b >> 6) != 2:  # invalid continuation
            return [], PartialUtf8(0, -1)
        value = (value << 6) + (b & 0x3F)
        i += 1
        n_remain -= 1
    if partial_start.n_remain > 0 and n_remain == 0:
        cps.append(value)
    while i < n:
        first = piece[i]
        highbits = first >> 4
        # NOTE: deliberate deviation from the reference here — its lookup
        # maps invalid start bytes (0x80-0xBF) to 1-byte chars whose value
        # masks into ASCII (e.g. byte-token 0xB9 passes a [0-9] grammar as
        # '9', emitting invalid UTF-8). We reject them instead.
        if 0x8 <= highbits <= 0xB:
            return [], PartialUtf8(0, -1)
        length = lookup[highbits]
        mask = (1 << (8 - length)) - 1
        value = first & mask
        i += 1
        n_remain = length - 1
        while n_remain > 0 and i < n:
            b = piece[i]
            if (b >> 6) != 2:
                return [], PartialUtf8(0, -1)
            value = (value << 6) + (b & 0x3F)
            i += 1
            n_remain -= 1
        if n_remain == 0:
            cps.append(value)
    return cps, PartialUtf8(value, n_remain) if n_remain > 0 else PartialUtf8(0, 0)


# ---------------------------------------------------------------------------
# GBNF parser (llama_grammar_parser)
# ---------------------------------------------------------------------------


class GrammarParseError(ValueError):
    pass


class GBNFParser:
    def __init__(self):
        self.symbol_ids: dict[str, int] = {}
        self.rules: list[list[tuple[int, int]]] = []

    def get_symbol_id(self, name: str) -> int:
        if name not in self.symbol_ids:
            self.symbol_ids[name] = len(self.symbol_ids)
        return self.symbol_ids[name]

    def generate_symbol_id(self, base: str) -> int:
        next_id = len(self.symbol_ids)
        self.symbol_ids[f"{base}_{next_id}"] = next_id
        return next_id

    def add_rule(self, rule_id: int, rule: list):
        while len(self.rules) <= rule_id:
            self.rules.append([])
        self.rules[rule_id] = rule

    # --- lexing helpers ---

    @staticmethod
    def _is_word_char(c: str) -> bool:
        return c.isalnum() or c in "-_"

    def _parse_space(self, src: str, pos: int, newline_ok: bool) -> int:
        while pos < len(src):
            c = src[pos]
            if c in " \t#" or (newline_ok and c in "\r\n"):
                if c == "#":
                    while pos < len(src) and src[pos] not in "\r\n":
                        pos += 1
                else:
                    pos += 1
            else:
                break
        return pos

    def _parse_char(self, src: str, pos: int) -> tuple[int, int]:
        if pos >= len(src):
            raise GrammarParseError("unexpected end of input")
        if src[pos] == "\\":
            esc = src[pos + 1] if pos + 1 < len(src) else ""
            if esc == "x":
                return int(src[pos + 2 : pos + 4], 16), pos + 4
            if esc == "u":
                return int(src[pos + 2 : pos + 6], 16), pos + 6
            if esc == "U":
                return int(src[pos + 2 : pos + 10], 16), pos + 10
            if esc == "t":
                return 9, pos + 2
            if esc == "r":
                return 13, pos + 2
            if esc == "n":
                return 10, pos + 2
            if esc in ('\\', '"', "[", "]"):
                return ord(esc), pos + 2
            raise GrammarParseError(f"unknown escape at {src[pos:pos+8]!r}")
        return ord(src[pos]), pos + 1

    def parse(self, text: str, start_rule: str = "root") -> tuple[list, int]:
        pos = self._parse_space(text, 0, True)
        while pos < len(text):
            pos = self._parse_rule(text, pos)
        if start_rule not in self.symbol_ids:
            raise GrammarParseError(f"undefined start rule {start_rule!r}")
        # validate all rule refs are defined
        for rid, rule in enumerate(self.rules):
            for typ, val in rule:
                if typ == RULE_REF and (val >= len(self.rules) or not self.rules[val]):
                    name = next((k for k, v in self.symbol_ids.items() if v == val), val)
                    raise GrammarParseError(f"undefined rule reference {name!r}")
        return self.rules, self.symbol_ids[start_rule]

    def _parse_rule(self, src: str, pos: int) -> int:
        name_start = pos
        while pos < len(src) and self._is_word_char(src[pos]):
            pos += 1
        if pos == name_start:
            raise GrammarParseError(f"expecting rule name at {src[pos:pos+12]!r}")
        name = src[name_start:pos]
        rule_id = self.get_symbol_id(name)
        pos = self._parse_space(src, pos, False)
        if src[pos : pos + 3] != "::=":
            raise GrammarParseError(f"expecting ::= at {src[pos:pos+12]!r}")
        pos = self._parse_space(src, pos + 3, True)
        pos = self._parse_alternates(src, pos, name, rule_id, False)
        if pos < len(src) and src[pos] == "\r":
            pos += 2 if src[pos : pos + 2] == "\r\n" else 1
        elif pos < len(src) and src[pos] == "\n":
            pos += 1
        elif pos < len(src):
            raise GrammarParseError(f"expecting newline or end at {src[pos:pos+12]!r}")
        return self._parse_space(src, pos, True)

    def _parse_alternates(self, src, pos, rule_name, rule_id, is_nested) -> int:
        rule: list = []
        pos = self._parse_sequence(src, pos, rule_name, rule, is_nested)
        while pos < len(src) and src[pos] == "|":
            rule.append((ALT, 0))
            pos = self._parse_space(src, pos + 1, True)
            pos = self._parse_sequence(src, pos, rule_name, rule, is_nested)
        rule.append((END, 0))
        self.add_rule(rule_id, rule)
        return pos

    def _parse_sequence(self, src, pos, rule_name, rule: list, is_nested) -> int:
        last_sym_start = len(rule)

        def handle_repetitions(min_times, max_times):
            nonlocal last_sym_start
            no_max = max_times is None
            if last_sym_start == len(rule):
                raise GrammarParseError(f"expecting preceding item to */+/?/{{ at {src[pos:pos+8]!r}")
            prev = rule[last_sym_start:]
            if min_times == 0:
                del rule[last_sym_start:]
            else:
                for _ in range(1, min_times):
                    rule.extend(prev)
            last_rec_rule_id = 0
            n_opt = 1 if no_max else max_times - min_times
            rec_rule = list(prev)
            for i in range(n_opt):
                del rec_rule[len(prev):]
                rec_rule_id = self.generate_symbol_id(rule_name)
                if i > 0 or no_max:
                    rec_rule.append((RULE_REF, rec_rule_id if no_max else last_rec_rule_id))
                rec_rule.append((ALT, 0))
                rec_rule.append((END, 0))
                self.add_rule(rec_rule_id, list(rec_rule))
                last_rec_rule_id = rec_rule_id
            if n_opt > 0:
                rule.append((RULE_REF, last_rec_rule_id))

        while pos < len(src):
            c = src[pos]
            if c == '"':
                pos += 1
                last_sym_start = len(rule)
                while pos < len(src) and src[pos] != '"':
                    cp, pos = self._parse_char(src, pos)
                    rule.append((CHAR, cp))
                if pos >= len(src):
                    raise GrammarParseError("unexpected end of input")
                pos = self._parse_space(src, pos + 1, is_nested)
            elif c == "[":
                pos += 1
                start_type = CHAR
                if pos < len(src) and src[pos] == "^":
                    pos += 1
                    start_type = CHAR_NOT
                last_sym_start = len(rule)
                while pos < len(src) and src[pos] != "]":
                    cp, pos = self._parse_char(src, pos)
                    typ = CHAR_ALT if last_sym_start < len(rule) else start_type
                    rule.append((typ, cp))
                    if pos < len(src) - 1 and src[pos] == "-" and src[pos + 1] != "]":
                        cp2, pos = self._parse_char(src, pos + 1)
                        rule.append((CHAR_RNG_UPPER, cp2))
                if pos >= len(src):
                    raise GrammarParseError("unexpected end of input")
                pos = self._parse_space(src, pos + 1, is_nested)
            elif self._is_word_char(c):
                name_start = pos
                while pos < len(src) and self._is_word_char(src[pos]):
                    pos += 1
                ref_id = self.get_symbol_id(src[name_start:pos])
                pos = self._parse_space(src, pos, is_nested)
                last_sym_start = len(rule)
                rule.append((RULE_REF, ref_id))
            elif c == "(":
                pos = self._parse_space(src, pos + 1, True)
                sub_id = self.generate_symbol_id(rule_name)
                pos = self._parse_alternates(src, pos, rule_name, sub_id, True)
                last_sym_start = len(rule)
                rule.append((RULE_REF, sub_id))
                if pos >= len(src) or src[pos] != ")":
                    raise GrammarParseError(f"expecting ')' at {src[pos:pos+8]!r}")
                pos = self._parse_space(src, pos + 1, is_nested)
            elif c == ".":
                last_sym_start = len(rule)
                rule.append((CHAR_ANY, 0))
                pos = self._parse_space(src, pos + 1, is_nested)
            elif c == "*":
                pos = self._parse_space(src, pos + 1, is_nested)
                handle_repetitions(0, None)
            elif c == "+":
                pos = self._parse_space(src, pos + 1, is_nested)
                handle_repetitions(1, None)
            elif c == "?":
                pos = self._parse_space(src, pos + 1, is_nested)
                handle_repetitions(0, 1)
            elif c == "{":
                pos = self._parse_space(src, pos + 1, is_nested)
                m = _re.match(r"(\d+)", src[pos:])
                if not m:
                    raise GrammarParseError(f"expecting an int at {src[pos:pos+8]!r}")
                min_times = int(m.group(1))
                pos = self._parse_space(src, pos + len(m.group(1)), is_nested)
                max_times = None
                if pos < len(src) and src[pos] == "}":
                    max_times = min_times
                    pos = self._parse_space(src, pos + 1, is_nested)
                elif pos < len(src) and src[pos] == ",":
                    pos = self._parse_space(src, pos + 1, is_nested)
                    m2 = _re.match(r"(\d+)", src[pos:])
                    if m2:
                        max_times = int(m2.group(1))
                        pos = self._parse_space(src, pos + len(m2.group(1)), is_nested)
                    if pos >= len(src) or src[pos] != "}":
                        raise GrammarParseError(f"expecting '}}' at {src[pos:pos+8]!r}")
                    pos = self._parse_space(src, pos + 1, is_nested)
                else:
                    raise GrammarParseError(f"expecting ',' at {src[pos:pos+8]!r}")
                if min_times > MAX_REPETITION_THRESHOLD or (
                    max_times is not None and max_times > MAX_REPETITION_THRESHOLD
                ):
                    raise GrammarParseError("number of repetitions exceeds sane defaults")
                handle_repetitions(min_times, max_times)
            else:
                break
        return pos


# ---------------------------------------------------------------------------
# pushdown engine
# ---------------------------------------------------------------------------


def _is_end(rule_elem) -> bool:
    return rule_elem[0] in (END, ALT)


class Grammar:
    """Compiled grammar + acceptance state."""

    def __init__(self, rules: list, start_rule_id: int, vocab=None,
                 lazy: bool = False, trigger_tokens=(), trigger_patterns=()):
        self.rules = [list(r) + ([(END, 0)] if not r or r[-1][0] != END else []) for r in rules]
        self.vocab = vocab
        self._detect_left_recursion()
        self.start_rule_id = start_rule_id
        self.partial_utf8 = PartialUtf8()
        self.lazy = lazy
        self.awaiting_trigger = lazy
        self.trigger_tokens = set(trigger_tokens)
        self.trigger_patterns = [_re.compile(p, _re.S) for p in trigger_patterns]
        self.trigger_buffer = ""
        self._piece_cache: dict[int, bytes] = {}

        # initial stacks: one per alternate of the start rule
        self.stacks: list[tuple] = []
        rule = self.rules[start_rule_id]
        i = 0
        while True:
            stack = ()
            if not _is_end(rule[i]):
                stack = ((start_rule_id, i),)
            self._advance_stack(stack, self.stacks)
            while not _is_end(rule[i]):
                i += 1
            if rule[i][0] == ALT:
                i += 1
            else:
                break

    @classmethod
    def from_gbnf(cls, text: str, vocab=None, start_rule: str = "root", **kw) -> "Grammar":
        parser = GBNFParser()
        rules, start_id = parser.parse(text, start_rule)
        return cls(rules, start_id, vocab=vocab, **kw)

    def _detect_left_recursion(self):
        n = len(self.rules)
        visited = [False] * n
        in_progress = [False] * n
        may_be_empty = [False] * n

        def detect(i) -> bool:
            if in_progress[i]:
                return True
            if visited[i]:
                return False
            in_progress[i] = True
            visited[i] = True
            rule = self.rules[i]
            j = 0
            while j < len(rule):
                # at start of an alternate: walk leading nonterminals
                if rule[j][0] == RULE_REF:
                    if detect(rule[j][1]):
                        return True
                    if not may_be_empty[rule[j][1]]:
                        # consume to end of alternate
                        while j < len(rule) and not _is_end(rule[j]):
                            j += 1
                    else:
                        j += 1
                        continue
                else:
                    while j < len(rule) and not _is_end(rule[j]):
                        j += 1
                if j < len(rule) and _is_end(rule[j]):
                    # empty alternate → rule may be empty
                    j += 1
            # crude may_be_empty: any alternate that is immediately END/ALT
            k = 0
            start = True
            while k < len(rule):
                if start and _is_end(rule[k]):
                    may_be_empty[i] = True
                start = _is_end(rule[k])
                k += 1
            in_progress[i] = False
            return False

        for i in range(n):
            if self.rules[i] and detect(i):
                raise GrammarParseError(f"left recursion detected for rule {i}")

    # -- core ops ----------------------------------------------------------

    def _elem(self, pos):
        return self.rules[pos[0]][pos[1]]

    def _match_char(self, pos, chr_: int):
        """Returns (matched, next_pos)."""
        rule = self.rules[pos[0]]
        i = pos[1]
        typ = rule[i][0]
        is_positive = typ in (CHAR, CHAR_ANY)
        found = False
        while True:
            if i + 1 < len(rule) and rule[i + 1][0] == CHAR_RNG_UPPER:
                found = found or (rule[i][1] <= chr_ <= rule[i + 1][1])
                i += 2
            elif rule[i][0] == CHAR_ANY:
                found = True
                i += 1
            else:
                found = found or rule[i][1] == chr_
                i += 1
            if i >= len(rule) or rule[i][0] != CHAR_ALT:
                break
        return (found == is_positive), (pos[0], i)

    def _match_partial_char(self, pos, partial: PartialUtf8) -> bool:
        rule = self.rules[pos[0]]
        i = pos[1]
        typ = rule[i][0]
        is_positive = typ in (CHAR, CHAR_ANY)
        value, n_remain = partial.value, partial.n_remain
        if n_remain < 0 or (n_remain == 1 and value < 2):
            return False
        low = value << (n_remain * 6)
        high = low | ((1 << (n_remain * 6)) - 1)
        if low == 0:
            if n_remain == 2:
                low = 1 << 11
            elif n_remain == 3:
                low = 1 << 16
        while True:
            if i + 1 < len(rule) and rule[i + 1][0] == CHAR_RNG_UPPER:
                if rule[i][1] <= high and low <= rule[i + 1][1]:
                    return is_positive
                i += 2
            elif rule[i][0] == CHAR_ANY:
                return True
            else:
                if low <= rule[i][1] <= high:
                    return is_positive
                i += 1
            if i >= len(rule) or rule[i][0] != CHAR_ALT:
                return not is_positive

    def _advance_stack(self, stack: tuple, new_stacks: list):
        if not stack:
            if stack not in new_stacks:
                new_stacks.append(stack)
            return
        pos = stack[-1]
        typ, val = self._elem(pos)
        if typ == RULE_REF:
            sub_rule = self.rules[val]
            i = 0
            while True:
                new_stack = list(stack[:-1])
                nxt = (pos[0], pos[1] + 1)
                if not _is_end(self._elem(nxt)):
                    new_stack.append(nxt)
                if not _is_end(sub_rule[i]):
                    new_stack.append((val, i))
                self._advance_stack(tuple(new_stack), new_stacks)
                while not _is_end(sub_rule[i]):
                    i += 1
                if sub_rule[i][0] == ALT:
                    i += 1
                else:
                    break
        elif typ in (CHAR, CHAR_NOT, CHAR_ANY):
            if stack not in new_stacks:
                new_stacks.append(stack)
        else:
            raise AssertionError(f"unexpected stack top {typ}")

    def accept_char(self, chr_: int):
        new_stacks: list = []
        for stack in self.stacks:
            if not stack:
                continue
            matched, next_pos = self._match_char(stack[-1], chr_)
            if matched:
                new_stack = list(stack[:-1])
                if not _is_end(self._elem(next_pos)):
                    new_stack.append(next_pos)
                self._advance_stack(tuple(new_stack), new_stacks)
        self.stacks = new_stacks

    def accept_str(self, text: str | bytes):
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        cps, self.partial_utf8 = decode_utf8(data, self.partial_utf8)
        if self.partial_utf8.n_remain < 0:
            self.stacks = []
        for cp in cps:
            self.accept_char(cp)
        if not self.stacks:
            raise ValueError(f"grammar: string {text!r} not accepted")

    # -- candidate rejection ----------------------------------------------

    def _reject_for_stack(self, stack, candidates):
        """candidates: list of (index, cp_offset_list, partial)."""
        rejects = []
        if not stack:
            for tok in candidates:
                idx, cps, off, partial = tok
                if off < len(cps) or partial.n_remain != 0:
                    rejects.append(tok)
            return rejects
        pos = stack[-1]
        next_candidates = []
        for tok in candidates:
            idx, cps, off, partial = tok
            if off >= len(cps):
                if partial.n_remain != 0 and not self._match_partial_char(pos, partial):
                    rejects.append(tok)
            elif self._match_char(pos, cps[off])[0]:
                next_candidates.append((idx, cps, off + 1, partial))
            else:
                rejects.append(tok)
        _, pos_after = self._match_char(pos, 0)
        stack_after = list(stack[:-1])
        if not _is_end(self._elem(pos_after)):
            stack_after.append(pos_after)
        next_stacks: list = []
        self._advance_stack(tuple(stack_after), next_stacks)
        for tok in self._reject_candidates(next_stacks, next_candidates):
            idx, cps, off, partial = tok
            rejects.append((idx, cps, off - 1, partial))
        return rejects

    def _reject_candidates(self, stacks, candidates):
        if not candidates or not stacks:
            return []
        rejects = self._reject_for_stack(stacks[0], candidates)
        for stack in stacks[1:]:
            rejects = self._reject_for_stack(stack, rejects)
        return rejects

    # -- sampler interface --------------------------------------------------

    def _piece(self, token: int) -> bytes:
        b = self._piece_cache.get(token)
        if b is None:
            from ..tokenizer.vocab import TokenAttr

            data = self.vocab.id_to_token[token]
            if data.attr & TokenAttr.BYTE and data.text.startswith("<0x"):
                b = bytes([int(data.text[3:5], 16)])
            else:
                b = self.vocab.token_to_piece(token, special=True).encode("utf-8")
            self._piece_cache[token] = b
        return b

    def apply(self, cur):
        """Mask candidates (llama_grammar_apply_impl). `cur` is a
        sampling.Candidates."""
        if self.awaiting_trigger:
            return None
        allow_eog = any(not s for s in self.stacks)
        decoded = []
        for i, tok in enumerate(cur.ids):
            tok = int(tok)
            piece = self._piece(tok)
            if self.vocab.is_eog(tok):
                if not allow_eog:
                    cur.logits[i] = -np.inf
            elif not piece or piece[0] == 0:
                cur.logits[i] = -np.inf
            else:
                cps, partial = decode_utf8(piece, self.partial_utf8)
                decoded.append((i, cps, 0, partial))
        for idx, _, _, _ in self._reject_candidates(self.stacks, decoded):
            cur.logits[idx] = -np.inf
        cur.sorted = False
        return None

    def accept(self, token: int):
        """Advance state on an accepted token (llama_grammar_accept_impl)."""
        piece = self._piece(token)
        if self.awaiting_trigger:
            if token in self.trigger_tokens:
                self.awaiting_trigger = False
                self.trigger_buffer = ""
                self.accept_str(piece)
                return
            self.trigger_buffer += piece.decode("utf-8", errors="replace")
            for pat in self.trigger_patterns:
                m = pat.fullmatch(self.trigger_buffer)
                if m:
                    self.awaiting_trigger = False
                    start = None
                    for g in range(1, (m.lastindex or 0) + 1):
                        if m.group(g):
                            start = m.start(g)
                            break
                    if start is None:
                        start = m.start(0)
                    constrained = self.trigger_buffer[start:]
                    self.trigger_buffer = ""
                    self.accept_str(constrained)
                    return
            return
        if self.vocab is not None and self.vocab.is_eog(token):
            if any(not s for s in self.stacks):
                return
            raise ValueError("grammar: EOG token rejected")
        self.accept_str(piece)

    def reset(self):
        self.__init__(
            self.rules,
            self.start_rule_id,
            vocab=self.vocab,
            lazy=self.lazy,
            trigger_tokens=self.trigger_tokens,
            trigger_patterns=[p.pattern for p in self.trigger_patterns],
        )


class GrammarSampler:
    """Sampler-chain adapter (llama_sampler_init_grammar)."""

    name = "grammar"

    def __init__(self, grammar: Grammar):
        self.grammar = grammar

    def apply(self, cur):
        return self.grammar.apply(cur)

    def accept(self, token: int):
        self.grammar.accept(token)

    def reset(self):
        self.grammar.reset()
