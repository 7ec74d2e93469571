"""Sampler chain.

Re-implements the reference's sampler vtable + chain
(src/llama-sampling.cpp; API surface include/llama.h:1195-1323) over a
numpy candidate array. Each sampler filters/reweights candidates;
`SamplerChain.sample` applies them in order and the terminal sampler
(greedy/dist/mirostat) selects a token. `accept` feeds back the chosen
token (penalties/DRY state).

Determinism: `dist`/`xtc`/mirostat use a seeded np.random.Generator.
(Exact RNG streams differ from std::mt19937 — the *distributions* and
all filtering semantics are identical.)

The device sampler (DeviceSamplerSpec, as_device_spec, device_sample) is
the port of the JAX package's fused chain: plain torch ops on the
logits' device that a captured decode step runs (runtime/context.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

DEFAULT_SEED = 0xFFFFFFFF  # LLAMA_DEFAULT_SEED


@dataclass
class Candidates:
    """llama_token_data_array analog (ids + logits [+ probs])."""

    ids: np.ndarray  # int32
    logits: np.ndarray  # float32
    probs: np.ndarray | None = None
    sorted: bool = False  # descending by logit

    @classmethod
    def from_logits(cls, logits: np.ndarray) -> "Candidates":
        logits = np.asarray(logits, np.float32)
        return cls(ids=np.arange(logits.shape[-1], dtype=np.int32), logits=logits.copy())

    def softmax(self, do_sort: bool = True):
        if do_sort and not self.sorted:
            order = np.argsort(-self.logits, kind="stable")
            self.ids = self.ids[order]
            self.logits = self.logits[order]
            self.sorted = True
        m = self.logits.max() if self.logits.size else 0.0
        e = np.exp(self.logits - m)
        self.probs = e / e.sum()

    def keep(self, mask_or_idx):
        self.ids = self.ids[mask_or_idx]
        self.logits = self.logits[mask_or_idx]
        if self.probs is not None:
            self.probs = self.probs[mask_or_idx]


class Sampler:
    name = "base"

    def apply(self, cur: Candidates) -> int | None:
        """Mutate candidates; terminal samplers return the chosen index."""
        return None

    def accept(self, token: int):
        pass

    def reset(self):
        pass


class Greedy(Sampler):
    name = "greedy"

    def apply(self, cur: Candidates):
        return int(np.argmax(cur.logits))


class Dist(Sampler):
    """Terminal multinomial sampler (llama_sampler_init_dist)."""

    name = "dist"

    def __init__(self, seed: int = DEFAULT_SEED):
        self.seed = seed
        self.reset()

    def reset(self):
        seed = self.seed if self.seed != DEFAULT_SEED else np.random.SeedSequence().entropy
        self.rng = np.random.default_rng(seed)

    def apply(self, cur: Candidates):
        cur.softmax(do_sort=False)
        return int(self.rng.choice(len(cur.ids), p=cur.probs / cur.probs.sum()))


class LogitBias(Sampler):
    name = "logit-bias"

    def __init__(self, bias: dict[int, float]):
        self.bias = dict(bias)

    def apply(self, cur: Candidates):
        if not self.bias:
            return None
        # cur.ids may be permuted; map id->index lazily
        for tok, b in self.bias.items():
            idx = np.nonzero(cur.ids == tok)[0]
            if idx.size:
                cur.logits[idx[0]] += b
        cur.sorted = False
        return None


class TopK(Sampler):
    name = "top-k"

    def __init__(self, k: int):
        self.k = k

    def apply(self, cur: Candidates):
        k = self.k
        if k <= 0 or k >= len(cur.ids):
            return None
        if not cur.sorted:
            part = np.argpartition(-cur.logits, k - 1)[:k]
            order = part[np.argsort(-cur.logits[part], kind="stable")]
            cur.keep(order)
            cur.sorted = True
        else:
            cur.keep(slice(0, k))
        return None


class TopP(Sampler):
    name = "top-p"

    def __init__(self, p: float, min_keep: int = 1):
        self.p = p
        self.min_keep = max(1, min_keep)

    def apply(self, cur: Candidates):
        if self.p >= 1.0:
            return None
        cur.softmax(do_sort=True)
        cum = np.cumsum(cur.probs)
        idx = np.nonzero(cum >= self.p)[0]
        last = (idx[0] + 1) if idx.size else len(cur.ids)
        last = max(last, self.min_keep)
        cur.keep(slice(0, last))
        return None


class MinP(Sampler):
    name = "min-p"

    def __init__(self, p: float, min_keep: int = 1):
        self.p = p
        self.min_keep = max(1, min_keep)

    def apply(self, cur: Candidates):
        if self.p <= 0.0 or not len(cur.ids):
            return None
        max_logit = cur.logits.max()
        min_logit = max_logit + np.log(self.p)
        mask = cur.logits >= min_logit
        if mask.sum() >= self.min_keep:
            cur.keep(mask)
            if not cur.sorted:
                cur.sorted = False
        else:
            order = np.argsort(-cur.logits, kind="stable")
            cur.keep(order[: self.min_keep])
            cur.sorted = True
        return None


class Typical(Sampler):
    name = "typical"

    def __init__(self, p: float, min_keep: int = 1):
        self.p = p
        self.min_keep = max(1, min_keep)

    def apply(self, cur: Candidates):
        if self.p >= 1.0:
            return None
        cur.softmax(do_sort=True)
        p = np.clip(cur.probs, 1e-30, None)
        entropy = float(-(p * np.log(p)).sum())
        shifted = np.abs(-np.log(p) - entropy)
        order = np.argsort(shifted, kind="stable")
        cum = np.cumsum(cur.probs[order])
        idx = np.nonzero(cum > self.p)[0]
        last = len(order)
        for i in idx[:1]:
            if self.min_keep == 0 or i >= self.min_keep - 1:
                last = i + 1
        cur.keep(order[:last])
        cur.sorted = False
        return None


class Temp(Sampler):
    name = "temp"

    def __init__(self, t: float):
        self.t = t

    def apply(self, cur: Candidates):
        if self.t <= 0:
            # keep only the max (llama_sampler_temp_impl)
            best = int(np.argmax(cur.logits))
            cur.logits[np.arange(len(cur.logits)) != best] = -np.inf
            return None
        cur.logits /= self.t
        return None


class TempExt(Sampler):
    """Dynamic-entropy temperature (llama_sampler_init_temp_ext)."""

    name = "temp-ext"

    def __init__(self, t: float, delta: float = 0.0, exponent: float = 1.0):
        self.t, self.delta, self.exponent = t, delta, exponent

    def apply(self, cur: Candidates):
        if self.delta <= 0:
            return Temp(self.t).apply(cur)
        if len(cur.ids) <= 1:
            return None
        min_temp = max(0.0, self.t - self.delta)
        max_temp = self.t + self.delta
        max_entropy = -np.log(1.0 / len(cur.ids))
        cur.softmax(do_sort=True)
        p = cur.probs[cur.probs > 0]
        entropy = float(-(p * np.log(p)).sum())
        norm = entropy / max_entropy
        dyn_temp = min_temp + (max_temp - min_temp) * (norm**self.exponent)
        cur.logits /= max(dyn_temp, 1e-6)
        cur.probs = None
        return None


class Xtc(Sampler):
    name = "xtc"

    def __init__(self, probability: float, threshold: float, min_keep: int = 1, seed: int = DEFAULT_SEED):
        self.probability, self.threshold, self.min_keep = probability, threshold, min_keep
        self.seed = seed
        self.reset()

    def reset(self):
        seed = self.seed if self.seed != DEFAULT_SEED else np.random.SeedSequence().entropy
        self.rng = np.random.default_rng(seed)

    def apply(self, cur: Candidates):
        if self.probability <= 0 or self.threshold > 0.5 or len(cur.ids) < 2:
            return None
        if self.rng.uniform() > self.probability:
            return None
        cur.softmax(do_sort=True)
        above = np.nonzero(cur.probs >= self.threshold)[0]
        pos_last = int(above[-1]) if above.size and (above == np.arange(above.size)).all() else 0
        if len(cur.ids) - pos_last >= self.min_keep and pos_last > 0:
            cur.keep(slice(pos_last, None))
        return None


class TopNSigma(Sampler):
    name = "top-n-sigma"

    def __init__(self, n: float):
        self.n = n

    def apply(self, cur: Candidates):
        if self.n <= 0 or len(cur.ids) <= 1:
            return None
        finite = np.isfinite(cur.logits)
        if not finite.any():
            return None
        mx = cur.logits[finite].max()
        mean = cur.logits[finite].mean()
        std = cur.logits[finite].std()
        cur.logits[cur.logits < mx - self.n * std] = -np.inf
        cur.softmax(do_sort=True)
        return None


class Penalties(Sampler):
    """Repeat/frequency/presence penalties (llama_sampler_init_penalties)."""

    name = "penalties"

    def __init__(self, last_n: int = 64, repeat: float = 1.0, freq: float = 0.0, present: float = 0.0):
        self.last_n, self.repeat, self.freq, self.present = last_n, repeat, freq, present
        self.prev: list[int] = []

    def reset(self):
        self.prev.clear()

    def accept(self, token: int):
        if self.last_n > 0:
            self.prev.append(token)
            if len(self.prev) > self.last_n:
                self.prev.pop(0)

    def apply(self, cur: Candidates):
        if self.last_n == 0 or (self.repeat == 1.0 and self.freq == 0.0 and self.present == 0.0):
            return None
        if not self.prev:
            return None
        counts: dict[int, int] = {}
        for t in self.prev:
            counts[t] = counts.get(t, 0) + 1
        toks = np.fromiter(counts.keys(), np.int32, len(counts))
        cnts = np.fromiter(counts.values(), np.float32, len(counts))
        id_pos = {int(t): i for i, t in enumerate(cur.ids)}
        for t, c in zip(toks, cnts):
            i = id_pos.get(int(t))
            if i is None:
                continue
            lg = cur.logits[i]
            lg = lg * self.repeat if lg <= 0 else lg / self.repeat
            lg -= c * self.freq + (1.0 if c > 0 else 0.0) * self.present
            cur.logits[i] = lg
        cur.sorted = False
        return None


class MirostatV2(Sampler):
    name = "mirostat-v2"

    def __init__(self, seed: int = DEFAULT_SEED, tau: float = 5.0, eta: float = 0.1):
        self.seed, self.tau, self.eta = seed, tau, eta
        self.reset()

    def reset(self):
        self.mu = 2.0 * self.tau
        seed = self.seed if self.seed != DEFAULT_SEED else np.random.SeedSequence().entropy
        self.rng = np.random.default_rng(seed)

    def apply(self, cur: Candidates):
        cur.softmax(do_sort=True)
        surprise = -np.log2(np.clip(cur.probs, 1e-30, None))
        keep = np.nonzero(surprise <= self.mu)[0]
        if keep.size == 0:
            keep = np.array([0])
        cur.keep(keep)
        cur.softmax(do_sort=True)
        idx = int(self.rng.choice(len(cur.ids), p=cur.probs / cur.probs.sum()))
        observed = -np.log2(max(cur.probs[idx], 1e-30))
        self.mu -= self.eta * (observed - self.tau)
        return idx


class MirostatV1(Sampler):
    """llama_sampler_init_mirostat (v1): surprise-targeting with estimated
    Zipf exponent (llama-sampling.cpp:1325+)."""

    name = "mirostat"

    def __init__(self, n_vocab: int, seed: int = DEFAULT_SEED, tau: float = 5.0,
                 eta: float = 0.1, m: int = 100):
        self.n_vocab, self.seed, self.tau, self.eta, self.m = n_vocab, seed, tau, eta, m
        self.reset()

    def reset(self):
        self.mu = 2.0 * self.tau
        seed = self.seed if self.seed != DEFAULT_SEED else np.random.SeedSequence().entropy
        self.rng = np.random.default_rng(seed)

    def apply(self, cur: Candidates):
        cur.softmax(do_sort=True)
        n = len(cur.ids)
        m = min(self.m, n - 1)
        if m < 2:
            return 0
        # estimate s_hat (Zipf exponent) from the top-m probabilities
        ti = np.log(np.arange(2, m + 1) / np.arange(1, m))
        b = np.log(cur.probs[: m - 1] / np.clip(cur.probs[1:m], 1e-30, None))
        s_hat = float((ti * b).sum() / (ti * ti).sum())
        eps = s_hat - 1.0
        k = ((eps * (2.0 ** self.mu)) / (1.0 - float(self.n_vocab) ** -eps)) ** (
            1.0 / s_hat
        )
        k = int(np.clip(np.round(k), 1, n))
        cur.keep(slice(0, k))
        cur.softmax(do_sort=True)
        idx = int(self.rng.choice(len(cur.ids), p=cur.probs / cur.probs.sum()))
        observed = -np.log2(max(float(cur.probs[idx]), 1e-30))
        self.mu -= self.eta * (observed - self.tau)
        return idx


class Dry(Sampler):
    """DRY repetition penalty (llama_sampler_init_dry semantics:
    Z-algorithm suffix-repeat detection, restart sequences, penalty =
    multiplier * base^(repeat_len - allowed_length))."""

    name = "dry"

    def __init__(self, vocab=None, multiplier: float = 0.0, base: float = 1.75,
                 allowed_length: int = 2, penalty_last_n: int = -1,
                 sequence_breakers=("\n", ":", '"', "*"), total_context: int = 4096):
        self.multiplier = multiplier
        self.base = base
        self.allowed_length = allowed_length
        self.penalty_last_n = penalty_last_n
        self.total_context = total_context
        self.last: list[int] = []
        # breaker sequences: {head_token: [tail tuples]}
        self.breakers: dict[int, list[tuple[int, ...]]] = {}
        if vocab is not None:
            for s in sequence_breakers:
                toks = vocab.tokenize(s, add_special=False, parse_special=False)
                # drop a leading space-prefix artifact token if present
                if len(toks) > 1 and vocab.token_to_piece(toks[0], special=False).strip() == "":
                    toks = toks[1:]
                if not toks:
                    continue
                head, tail = toks[0], tuple(toks[1:10])
                self.breakers.setdefault(head, []).append(tail)

    def reset(self):
        self.last.clear()

    def accept(self, token: int):
        self.last.append(token)
        cap = self.total_context if self.penalty_last_n < 0 else self.penalty_last_n
        if len(self.last) > cap:
            del self.last[: len(self.last) - cap]

    def apply(self, cur: Candidates):
        if self.multiplier == 0.0 or self.base < 1.0 or self.penalty_last_n == 0:
            return None
        eff_n = self.total_context if self.penalty_last_n < 0 else max(self.penalty_last_n, 0)
        n = min(len(self.last), eff_n, self.total_context)
        if n <= self.allowed_length:
            return None
        toks = self.last[-n:]

        def rat(i):  # i tokens from the end
            return toks[n - 1 - i]

        # step 1: restart sequences limit the repeat window
        rep_limit = n
        for i in range(n):
            tails = self.breakers.get(rat(i))
            if tails is None:
                continue
            longest = -1
            for tail in tails:
                sl = len(tail)
                if sl > longest and sl <= i:
                    if all(tail[o] == rat(i - o - 1) for o in range(sl)):
                        longest = sl
            if longest >= 0:
                rep_limit = i - longest
                break
        if rep_limit < self.allowed_length:
            return None

        # step 2: reverse Z-algorithm suffix-repeat lengths
        repeat = [0] * n
        last = n - 1
        lt = rt = 0
        for k in range(1, n):
            if k > rt:
                m = 0
                while m + k < n and rat(m) == rat(m + k):
                    m += 1
                repeat[last - k] = min(m, rep_limit)
                if m > 0:
                    lt, rt = k, k + m - 1
            else:
                p = k - lt
                right = rt - k + 1
                if repeat[last - p] < right:
                    repeat[last - k] = min(repeat[last - p], rep_limit)
                else:
                    i = rt + 1
                    while i < n and rat(i) == rat(i - k):
                        i += 1
                    repeat[last - k] = min(i - k, rep_limit)
                    lt, rt = k, i - 1

        # step 3: max repeat length per continuation token
        max_rep: dict[int, int] = {}
        for i in range(n - 1):
            rl = repeat[i]
            if rl >= self.allowed_length:
                tok = rat(n - 2 - i)
                if max_rep.get(tok, 0) < rl:
                    max_rep[tok] = rl
        if not max_rep:
            return None

        # step 4: penalties
        max_exp = 88.7228391 / np.log(self.base) if self.base > 1.000001 else 0
        id_pos = {int(t): i for i, t in enumerate(cur.ids)}
        for tok, rl in max_rep.items():
            tails = self.breakers.get(tok)
            if tails is not None and any(len(t) == 0 for t in tails):
                continue  # single-token breakers are never penalized
            i = id_pos.get(tok)
            if i is None:
                continue
            exponent = rl - self.allowed_length
            if max_exp and exponent > max_exp:
                exponent = max_exp
            cur.logits[i] -= self.multiplier * (self.base ** exponent)
        cur.sorted = False
        return None


class Infill(Sampler):
    """Fill-in-middle sampler (llama_sampler_init_infill,
    src/llama-sampling.cpp llama_sampler_infill_apply): biases toward EOG
    when text probability is low, merges prefix-overlapping token pieces,
    and applies two keep-thresholds. Meant to run after top-k-style
    filters (the pair merge is O(n^2) in candidate count)."""

    name = "infill"

    def __init__(self, vocab):
        self.vocab = vocab

    def _piece(self, tok: int) -> bytes:
        try:
            return self.vocab.token_to_piece(int(tok), special=False).encode("utf-8")
        except Exception:
            return b""

    def apply(self, cur: Candidates):
        cur.softmax(do_sort=True)
        is_eog = np.array([self.vocab.is_eog(int(t)) for t in cur.ids])
        p = cur.probs
        p_eog_sum = float(p[is_eog].sum())
        p_txt_sum = float(p[~is_eog].sum())

        if 3.0 * p_eog_sum * len(cur.ids) > p_txt_sum:
            # low text probability -> keep just the EOG tokens
            cur.keep(is_eog)
            if cur.probs is not None and cur.probs.sum() > 0:
                cur.probs = cur.probs / cur.probs.sum()
            return None

        # combine tokens sharing a piece prefix (merge into the likelier one)
        n = len(cur.ids)
        pieces = [self._piece(t) for t in cur.ids]
        logits, probs = cur.logits, cur.probs
        for i0 in range(n):
            for i1 in range(n):
                if logits[i0] == -np.inf:
                    break
                if i0 == i1 or logits[i1] == -np.inf:
                    continue
                p0, p1 = pieces[i0], pieces[i1]
                if p0 and len(p0) <= len(p1) and p1.startswith(p0):
                    dst, src = (i1, i0) if probs[i1] > probs[i0] else (i0, i1)
                    probs[dst] += probs[src]
                    logits[src] = -np.inf
                    probs[src] = 0.0

        # threshold pass 1: drop non-EOG below 0.2
        keep = (probs >= 0.2) | is_eog
        n_non_eog = int((keep & ~is_eog).sum())
        if n_non_eog == 0:
            # reduce to a single EOT (or EOS) token
            eot = getattr(self.vocab, "eot_id", -1)
            if eot is None or eot < 0:
                eot = self.vocab.eos_id
            cur.ids = np.array([eot], np.int32)
            cur.logits = np.array([1.0], np.float32)
            cur.probs = np.array([1.0], np.float32)
            return None
        cur.keep(keep)
        cur.probs = cur.probs / cur.probs.sum()

        # threshold pass 2: drop non-EOG below 1/(n_non_eog+1)
        is_eog = is_eog[keep]
        thold = 1.0 / (n_non_eog + 1)
        keep2 = (cur.probs >= thold) | is_eog
        cur.keep(keep2)
        cur.probs = cur.probs / cur.probs.sum()
        return None


class SamplerChain:
    """llama_sampler_chain analog; also the common_sampler convenience
    constructor (common/sampling.cpp std chain order: penalties → top-k →
    typical → top-p → min-p → xtc → temp → dist)."""

    def __init__(self, samplers: list[Sampler]):
        self.samplers = samplers

    @classmethod
    def from_params(
        cls,
        *,
        vocab=None,
        seed: int = DEFAULT_SEED,
        temp: float = 0.8,
        dynatemp_range: float = 0.0,
        dynatemp_exponent: float = 1.0,
        top_k: int = 40,
        top_p: float = 0.95,
        min_p: float = 0.05,
        typical_p: float = 1.0,
        xtc_probability: float = 0.0,
        xtc_threshold: float = 0.1,
        top_n_sigma: float = -1.0,
        penalty_last_n: int = 64,
        penalty_repeat: float = 1.0,
        penalty_freq: float = 0.0,
        penalty_present: float = 0.0,
        dry_multiplier: float = 0.0,
        dry_base: float = 1.75,
        dry_allowed_length: int = 2,
        dry_penalty_last_n: int = -1,
        dry_sequence_breakers: list | None = None,
        mirostat: int = 0,
        mirostat_tau: float = 5.0,
        mirostat_eta: float = 0.1,
        logit_bias: dict[int, float] | None = None,
        n_vocab: int = 0,
    ) -> "SamplerChain":
        """Full common_sampler default chain (common/sampling.cpp:240-300
        order: logit-bias -> penalties -> dry -> top-n-sigma -> top-k ->
        typical -> top-p -> min-p -> xtc -> temp-ext -> dist; mirostat>0
        replaces the truncation samplers with temp + mirostat)."""
        chain: list[Sampler] = []
        if logit_bias:
            chain.append(LogitBias(logit_bias))
        chain.append(Penalties(penalty_last_n, penalty_repeat, penalty_freq,
                               penalty_present))
        if dry_multiplier > 0:
            dry_kw = dict(vocab=vocab, multiplier=dry_multiplier, base=dry_base,
                          allowed_length=dry_allowed_length,
                          penalty_last_n=dry_penalty_last_n)
            if dry_sequence_breakers is not None:
                dry_kw["sequence_breakers"] = tuple(dry_sequence_breakers)
            chain.append(Dry(**dry_kw))
        if temp <= 0:
            chain.append(Greedy())
            return cls(chain)
        if mirostat == 1:
            chain += [Temp(temp), MirostatV1(n_vocab or 32768, seed, mirostat_tau,
                                             mirostat_eta)]
            return cls(chain)
        if mirostat == 2:
            chain += [Temp(temp), MirostatV2(seed, mirostat_tau, mirostat_eta)]
            return cls(chain)
        if top_n_sigma >= 0:
            chain.append(TopNSigma(top_n_sigma))
        chain += [
            TopK(top_k),
            Typical(typical_p),
            TopP(top_p),
            MinP(min_p),
        ]
        if xtc_probability > 0:
            chain.append(Xtc(xtc_probability, xtc_threshold, seed=seed))
        if dynatemp_range > 0:
            chain.append(TempExt(temp, dynatemp_range, dynatemp_exponent))
        else:
            chain.append(Temp(temp))
        chain.append(Dist(seed))
        return cls(chain)

    @classmethod
    def std(
        cls,
        *,
        seed: int = 42,
        temp: float = 0.8,
        top_k: int = 40,
        top_p: float = 0.95,
        min_p: float = 0.05,
        typical_p: float = 1.0,
        penalty_last_n: int = 64,
        penalty_repeat: float = 1.0,
        penalty_freq: float = 0.0,
        penalty_present: float = 0.0,
        logit_bias: dict[int, float] | None = None,
    ) -> "SamplerChain":
        chain: list[Sampler] = []
        if logit_bias:
            chain.append(LogitBias(logit_bias))
        chain.append(Penalties(penalty_last_n, penalty_repeat, penalty_freq, penalty_present))
        if temp <= 0:
            chain.append(Greedy())
        else:
            chain += [
                TopK(top_k),
                Typical(typical_p),
                TopP(top_p),
                MinP(min_p),
                Temp(temp),
                Dist(seed),
            ]
        return cls(chain)

    @classmethod
    def greedy(cls) -> "SamplerChain":
        return cls([Greedy()])

    def sample(self, logits: np.ndarray) -> int:
        cur = Candidates.from_logits(logits)
        chosen = None
        for s in self.samplers:
            r = s.apply(cur)
            if r is not None:
                chosen = r
        if chosen is None:
            chosen = int(np.argmax(cur.logits))
        token = int(cur.ids[chosen])
        self.accept(token)
        return token

    def accept(self, token: int):
        for s in self.samplers:
            s.accept(token)

    def reset(self):
        for s in self.samplers:
            s.reset()


@dataclass(frozen=True)
class DeviceSamplerSpec:
    """Static description of a sampler chain that can run inside the
    on-device decode step (runtime/context.py sampled burst): the common
    temp/top-k/top-p/min-p/dist chain. Hashable: a Context keys its
    captured step programs by it.

    The RNG is a torch.Generator on the step's device (philox on CUDA,
    mt19937 on the CPU), seeded from `seed`: neither the JAX package's
    threefry stream nor the reference's mt19937 stream, the same documented
    divergence the JAX package has (the distribution matches, not the
    stream)."""

    temp: float
    top_k: int
    top_p: float
    min_p: float
    seed: int


def as_device_spec(chain: "SamplerChain") -> DeviceSamplerSpec | None:
    """Map a SamplerChain onto a DeviceSamplerSpec when every member is
    device-expressible (no-op members allowed); None -> host fallback.

    Covered: Greedy (temp=0), TopK, TopP, MinP, Temp, Dist, no-op
    Penalties / Typical(1) / LogitBias({}). Anything stateful
    (penalties in effect, mirostat, dry, grammar) stays on host."""
    temp, top_k, top_p, min_p, seed = 1.0, 0, 1.0, 0.0, DEFAULT_SEED
    greedy = False
    for s in chain.samplers:
        if isinstance(s, Greedy):
            greedy = True
        elif isinstance(s, Penalties):
            if s.repeat != 1.0 or s.freq != 0.0 or s.present != 0.0:
                return None
        elif isinstance(s, LogitBias):
            if s.bias:
                return None
        elif isinstance(s, Typical):
            if s.p < 1.0:
                return None
        elif isinstance(s, TopK):
            top_k = s.k
        elif isinstance(s, TopP):
            top_p = s.p
        elif isinstance(s, MinP):
            min_p = s.p
        elif isinstance(s, Temp):
            temp = s.t
        elif isinstance(s, Dist):
            seed = s.seed
        else:
            return None
    if greedy or temp <= 0:
        return DeviceSamplerSpec(0.0, 0, 1.0, 0.0, seed)
    return DeviceSamplerSpec(float(temp), int(top_k), float(top_p),
                             float(min_p), int(seed))


def device_candidates(logits, spec: DeviceSamplerSpec):
    """The truncations of device_sample (spec.temp > 0): the top-k ids
    (256 when top_k is unset), sorted by logit, and their tempered logits,
    -inf where top-p or min-p drops them. logits: (V,) f32 tensor."""
    import torch

    V = logits.shape[-1]
    k = spec.top_k if 0 < spec.top_k < V else min(V, 256)
    vals, idx = torch.topk(logits, k)  # sorted descending
    probs = torch.softmax(vals.float(), dim=-1)
    keep = torch.ones(k, dtype=torch.bool, device=logits.device)
    if spec.top_p < 1.0:
        # keep until the cumulative probability first reaches top_p
        # (inclusive), llama-sampling.cpp llama_sampler_top_p_apply
        cum = torch.cumsum(probs, dim=-1)
        keep &= (cum - probs) < spec.top_p
    if spec.min_p > 0.0:
        keep &= probs >= spec.min_p * probs[0]
    keep[0].fill_(True)  # min_keep = 1 (a fill: no host copy inside a graph)
    logt = torch.where(keep, vals / spec.temp, torch.full_like(vals, float("-inf")))
    return idx, logt


def device_sample(logits, generator, spec: DeviceSamplerSpec):
    """One sampling step on the logits' device, with no host read (a CUDA
    graph captures it). logits: (V,) f32 tensor; generator: a
    torch.Generator on that device. Returns a 0-dim int32 tensor. The
    common_sampler std chain order (common/sampling.cpp: top-k -> top-p ->
    min-p -> temp -> dist), the truncations computed on the softmax of the
    UNtempered logits, exactly like the host chain; the draw is Gumbel-max,
    argmax(logt + Gumbel(u)), which is what jax.random.categorical
    computes. A generator other than the device's default must be
    registered with the graph that captures this
    (CUDAGraph.register_generator_state), or each replay repeats the
    capture's draw."""
    import torch

    if spec.temp <= 0:
        return torch.argmax(logits).to(torch.int32)
    idx, logt = device_candidates(logits, spec)
    u = torch.rand(logt.shape, generator=generator, device=logt.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    # gather, not idx[tensor]: a 0-dim index would be read on the host
    return idx.gather(0, torch.argmax(logt + gumbel).reshape(1))[0].to(torch.int32)
