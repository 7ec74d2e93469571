"""Speculative decoding: draft-model proposer + exact-match verification
(port of tpullama/runtime/speculative.py over the port's Context: the
draft's one-token steps replay its CUDA graphs on the card, and the
target verifies [last + drafts] in one eager prefill).

Semantics follow the reference precisely (SURVEY.md A.9;
common/speculative.cpp:185+, common/sampling.cpp:437-466):

- the draft context reuses its previous prompt via longest common prefix
  (n_reuse); drafting stops when the draft's top probability falls below
  p_min (greedy proposals, confidence-gated);
- verification decodes [last_token + draft] in ONE target batch, then
  walks positions sampling with the *target* chain — accept while
  draft[i] == sampled; on first mismatch keep the target's token and
  discard the rest. Always emits >= 1 token. Exact-match acceptance keeps
  the output distribution identical to target-only sampling for a
  deterministic chain;
- KV tail rollback via seq_rm (server-context.cpp:2480).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .context import Context, ContextParams


@dataclass
class SpeculativeParams:
    """common_speculative_params (common/speculative.h:8-13)."""

    n_draft: int = 16
    n_reuse: int = 256
    p_min: float = 0.75


class Speculative:
    def __init__(self, draft_model, params: SpeculativeParams | None = None,
                 n_ctx: int = 1024):
        self.model = draft_model
        self.p = params or SpeculativeParams()
        self.ctx = Context(draft_model, ContextParams(n_ctx=n_ctx))
        self.prompt: list[int] = []  # draft ctx token history

    def gen_draft(self, prompt_tgt: list[int], id_last: int) -> list[int]:
        """Propose up to n_draft tokens following [prompt_tgt..., id_last]."""
        p = self.p
        # reuse longest common prefix of the draft context's history
        reuse_i = 0
        reuse_n = 0
        start = max(0, len(self.prompt) - p.n_reuse)
        for i in range(start, len(self.prompt)):
            cur = 0
            while (
                i + cur < len(self.prompt)
                and cur < len(prompt_tgt)
                and self.prompt[i + cur] == prompt_tgt[cur]
            ):
                cur += 1
            if cur > reuse_n:
                reuse_i = i
                reuse_n = cur
        if reuse_n == 0 and self.prompt:
            self.ctx.reset()
            self.prompt = []
        elif reuse_i > 0:
            # shift the reused window to the start (seq_rm + seq_add)
            self.ctx.seq_rm(0, reuse_i)
            self.ctx.seq_add(reuse_i, -1 + (1 << 30), -reuse_i)
            self.prompt = self.prompt[reuse_i : reuse_i + reuse_n]
        if reuse_n and reuse_n < len(self.prompt):
            self.ctx.seq_rm(reuse_n, -1)
            self.prompt = self.prompt[:reuse_n]

        # feed the not-yet-seen target tokens + id_last into the draft ctx
        new_toks = list(prompt_tgt[reuse_n:]) + [id_last]
        logits = self.ctx.decode(np.asarray(new_toks, np.int32), n_logits=1)[-1]
        self.prompt += new_toks

        drafts: list[int] = []
        for _ in range(self.p.n_draft):
            probs = _softmax(logits)
            tok = int(np.argmax(probs))
            if probs[tok] < p.p_min:
                break
            drafts.append(tok)
            if self.model.vocab is not None and self.model.vocab.is_eog(tok):
                break
            logits = self.ctx.decode(np.asarray([tok], np.int32), n_logits=1)[-1]
            self.prompt.append(tok)
        return drafts


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max())
    return e / e.sum()


def sample_and_accept_n(sampler, logits_rows: np.ndarray, drafts: list[int]) -> list[int]:
    """common_sampler_sample_and_accept_n: walk draft positions with the
    target chain; accept while equal; keep the target token at the first
    mismatch. Returns the accepted tokens (>= 1)."""
    out: list[int] = []
    for i in range(len(drafts) + 1):
        if sampler is None:
            tok = int(np.argmax(logits_rows[i]))
        else:
            tok = sampler.sample(logits_rows[i])
        out.append(tok)
        if i >= len(drafts) or drafts[i] != tok:
            break
    return out


def generate_speculative(
    ctx_tgt: Context,
    spec: Speculative,
    prompt_tokens: list[int],
    n_predict: int = 64,
    sampler=None,
) -> tuple[list[int], dict]:
    """Full speculative generation loop (server-context.cpp:2414-2520).
    Returns (tokens, stats)."""
    vocab = ctx_tgt.model.vocab
    prompt_tokens = list(prompt_tokens)
    logits = ctx_tgt.decode(np.asarray(prompt_tokens, np.int32), n_logits=1)[-1]
    if sampler is None:
        id_last = int(np.argmax(logits))
    else:
        id_last = sampler.sample(logits)
    out = [id_last]
    history = list(prompt_tokens)
    n_drafted = 0
    n_accepted = 0

    while len(out) < n_predict and not (vocab is not None and vocab.is_eog(id_last)):
        drafts = spec.gen_draft(history, id_last)
        n_drafted += len(drafts)
        batch = [id_last] + drafts
        logits_rows = ctx_tgt.decode(
            np.asarray(batch, np.int32), n_logits=len(batch)
        )
        accepted = sample_and_accept_n(sampler, logits_rows, drafts)
        n_accepted += len(accepted) - 1
        # rollback target KV for rejected draft tail
        n_keep = int(ctx_tgt.n_past[0]) - (len(batch) - len(accepted))
        if len(accepted) < len(batch):
            ctx_tgt.seq_rm(n_keep, -1)
        history += [id_last] + accepted[:-1]
        for tok in accepted:
            out.append(tok)
            if len(out) >= n_predict or (vocab is not None and vocab.is_eog(tok)):
                break
        id_last = out[-1]

    stats = {
        "n_drafted": n_drafted,
        "n_accepted": n_accepted,
        "accept_rate": n_accepted / n_drafted if n_drafted else 0.0,
    }
    return out[:n_predict], stats
