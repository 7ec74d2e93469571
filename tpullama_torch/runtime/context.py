"""Decode engine: KV cache + prefill/decode steps (port of
tpullama/runtime/context.py:Context for the plain llama family).

The cache is HEAD-MAJOR (L, B, Hkv, S, D), one lane per sequence (the
reference's per-stream layout), with S = n_ctx + 1 scratch cell rounded
up to a multiple of 128. Sequence positions live twice: `kv_pos` (B, S) on
the device (-1 = empty cell), from which each step builds its additive
mask, and `_pos_host`, the host mirror the free-cell allocator reads.

Differences from the JAX package, by design:
  - the cache is written in place (models/llama.py scatter_rows) instead
    of being donated and returned by a jitted program;
  - a per-sequence step runs on views of that sequence's cache lane;
  - the fused greedy burst (decode_batch_burst) is a loop of decode_batch
    steps with an on-device argmax, returning the same (K, B) ids and
    keeping the same host bookkeeping.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models.hparams import HParams
from ..models.llama import LlamaModel
from ..models.loader import LoadedModel, check_supported

NEG_INF = -1e30  # avoids NaN rows for fully-masked (padded) queries


@dataclass
class ContextParams:
    """llama_context_default_params analog."""

    n_ctx: int = 512  # per sequence
    n_batch: int = 2048
    n_ubatch: int = 512
    n_seqs: int = 1
    dtype: torch.dtype = torch.float32
    kv_dtype: torch.dtype | None = None  # default: same as dtype
    # multi-device mode ("pp" / "tp"): not ported yet, refused by make_context
    parallel: str | None = None


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass
class PerfCounters:
    """llama_perf_context analog."""

    t_load_ms: float = 0.0
    t_prefill_ms: float = 0.0
    t_decode_ms: float = 0.0
    n_prefill: int = 0
    n_decode: int = 0
    n_reused: int = 0

    def prefill_tps(self) -> float:
        return self.n_prefill / (self.t_prefill_ms / 1000) if self.t_prefill_ms else 0.0

    def decode_tps(self) -> float:
        return self.n_decode / (self.t_decode_ms / 1000) if self.t_decode_ms else 0.0


class Context:
    def __init__(self, model: LoadedModel, params: ContextParams | None = None,
                 fused_layer: bool | None = None, qmm_tile_k: int | None = None):
        """`fused_layer` and `qmm_tile_k` go to the model (LlamaModel): the
        fused post-attention path and the packed matmuls' K-chunks, by
        default from TPULLAMA_FUSED_LAYER and TPULLAMA_QMM_TILE_K."""
        self.model = model
        self.hp: HParams = model.hparams
        check_supported(self.hp)
        self.p = params or ContextParams()
        self.device = model.device
        hp = self.hp
        B = self.p.n_seqs
        S = -(-(self.p.n_ctx + 1) // 128) * 128
        self._S = S
        kv_dt = self.p.kv_dtype or self.p.dtype
        if not kv_dt.is_floating_point:
            raise NotImplementedError(
                f"kv_dtype {kv_dt}: the int8 KV cache is not ported yet "
                "(ROADMAP.md Queue 1 item 4)")
        Hkv, Dk, Dv = hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
        # HEAD-MAJOR cache (L, B, Hkv, S, D): attention streams each head's
        # rows contiguously; the writer scatters its few rows
        self.kv_k = torch.zeros((hp.n_layer, B, Hkv, S, Dk), dtype=kv_dt, device=self.device)
        self.kv_v = torch.zeros((hp.n_layer, B, Hkv, S, Dv), dtype=kv_dt, device=self.device)
        self.kv_pos = torch.full((B, S), -1, dtype=torch.int32, device=self.device)
        self._pos_host = np.full((B, S), -1, np.int32)
        self.n_past = np.zeros(B, np.int32)
        self.perf = PerfCounters()
        self.net = LlamaModel(model.params, hp, model.quant_meta, fused_layer=fused_layer,
                              qmm_tile_k=qmm_tile_k)

    # ------------------------------------------------------------------

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _forward(self, kv_k, kv_v, kv_pos, tokens, positions, slots, logit_rows=None):
        """Shared core: record the new cells' positions, build the additive
        mask, run the model (which writes K/V in place)."""
        B, T = tokens.shape
        b_ix = torch.arange(B, device=self.device)[:, None]
        kv_pos[b_ix, slots.long()] = positions
        kp = kv_pos[:, None, :]
        vis = (kp >= 0) & (kp <= positions[:, :, None])
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        neg = torch.full((), NEG_INF, dtype=torch.float32, device=self.device)
        mask = torch.where(vis, zero, neg)[:, None]
        return self.net(tokens, positions, kv_k, kv_v, slots, mask, logit_rows=logit_rows)

    def _step_seq(self, seq: int, tokens, positions, slots, n_logits: int):
        """Prefill/decode for ONE sequence on views of its cache lane."""
        T = tokens.shape[1]
        rows = torch.arange(T - n_logits, T, device=self.device)[None]
        logits = self._forward(
            self.kv_k[:, seq:seq + 1], self.kv_v[:, seq:seq + 1],
            self.kv_pos[seq:seq + 1], tokens, positions, slots, logit_rows=rows)
        return logits[0]

    # ------------------------------------------------------- decode APIs

    def decode(self, tokens: np.ndarray, n_logits: int = 1, seq_id: int = 0) -> np.ndarray:
        """Process tokens for one sequence. tokens: (T,) int.
        Returns logits (n_logits, n_vocab)."""
        tokens = np.asarray(tokens, np.int32).reshape(1, -1)
        _, T = tokens.shape
        n_past = int(self.n_past[seq_id])
        if n_past + T > self.p.n_ctx:
            raise ValueError(
                f"context overflow: {n_past}+{T} > n_ctx={self.p.n_ctx} "
                f"(use seq_rm / context shift)"
            )
        Tb = _bucket(T) if T > 1 else 1
        pad = Tb - T
        S = self._S
        toks = np.pad(tokens, ((0, 0), (0, pad)))
        rng = np.arange(n_past, n_past + T, dtype=np.int32).reshape(1, T)
        pos = np.pad(rng, ((0, 0), (0, pad)), constant_values=-1)
        free = np.nonzero(self._pos_host[seq_id, : S - 1] < 0)[0]
        if len(free) < T:
            raise ValueError(f"no free KV cells: need {T}, have {len(free)}")
        srow = free[:T].astype(np.int32).reshape(1, T)
        slots = np.pad(srow, ((0, 0), (0, pad)), constant_values=S - 1)
        self._pos_host[seq_id, srow[0]] = rng[0]
        t0 = time.perf_counter()
        # logits of the last n_logits real tokens (padding sits after them)
        logits = self._step_seq(seq_id, self._t(toks), self._t(pos), self._t(slots),
                                n_logits + pad)
        out = logits.cpu().numpy()
        dt = (time.perf_counter() - t0) * 1000
        if T > 1:
            self.perf.t_prefill_ms += dt
            self.perf.n_prefill += T
        else:
            self.perf.t_decode_ms += dt
            self.perf.n_decode += 1
        self.n_past[seq_id] = n_past + T
        if pad:
            out = out[:n_logits]
        return out

    def _batch_inputs(self, tokens, active):
        B = self.p.n_seqs
        S = self._S
        tokens = np.asarray(tokens, np.int32).reshape(B, 1)
        active = np.asarray(active, bool)
        pos = np.where(active, self.n_past, -1).astype(np.int32).reshape(B, 1)
        slots = np.full(B, S - 1, np.int32)
        for b in range(B):
            if active[b]:
                free = np.nonzero(self._pos_host[b, : S - 1] < 0)[0]
                if len(free) == 0:
                    raise ValueError(f"no free KV cells for seq {b}")
                slots[b] = free[0]
                self._pos_host[b, free[0]] = int(self.n_past[b])
        return tokens, active, pos, slots.reshape(B, 1)

    def decode_batch(self, tokens: np.ndarray, active: np.ndarray) -> np.ndarray:
        """One decode step for all sequences (continuous batching hot loop).
        tokens: (B,) int32, active: (B,) bool. Returns logits (B, n_vocab);
        inactive rows are garbage."""
        tokens, active, pos, slots = self._batch_inputs(tokens, active)
        t0 = time.perf_counter()
        logits = self._forward(self.kv_k, self.kv_v, self.kv_pos, self._t(tokens),
                               self._t(pos), self._t(slots))
        out = logits[:, -1, :].cpu().numpy()
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1000
        self.perf.n_decode += int(active.sum())
        self.n_past[active] += 1
        return out

    def decode_batch_burst(self, tokens: np.ndarray, active: np.ndarray,
                           n_steps: int) -> np.ndarray:
        """Greedy-decode n_steps tokens for every active lane with one host
        read at the end. tokens: (B,) last sampled token per lane. Returns
        (n_steps, B) generated ids (inactive columns echo their input).
        Each active lane's cache advances n_steps (input token, out[0], ...,
        out[n_steps-2]). Each step picks every lane's first free cell on
        the device (ascending, matching the host mirror's free-list order);
        inactive lanes park on the scratch cell with position -1."""
        B = self.p.n_seqs
        S = self._S
        toks = self._t(np.asarray(tokens, np.int32).reshape(B, 1))
        active = np.asarray(active, bool)
        act_idx = np.nonzero(active)[0]
        frees = {}
        for b in act_idx:
            if int(self.n_past[b]) + n_steps > self.p.n_ctx:
                raise ValueError(f"context overflow for burst on seq {b}")
            free = np.nonzero(self._pos_host[b, : S - 1] < 0)[0]
            if len(free) < n_steps:
                raise ValueError(f"no free KV cells for burst on seq {b}")
            frees[b] = free[:n_steps]
        act = self._t(active)
        npast = self._t(self.n_past.astype(np.int32))
        scratch = torch.full((B,), S - 1, dtype=torch.int32, device=self.device)
        outs = []
        t0 = time.perf_counter()
        for _ in range(n_steps):
            free = torch.argmax((self.kv_pos[:, : S - 1] < 0).to(torch.int32), dim=1)
            slots = torch.where(act, free.to(torch.int32), scratch)[:, None]
            pos = torch.where(act, npast, torch.full_like(npast, -1))[:, None]
            logits = self._forward(self.kv_k, self.kv_v, self.kv_pos, toks, pos, slots)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
            toks = torch.where(act[:, None], nxt, toks)
            npast = npast + act.to(torch.int32)
            outs.append(toks[:, 0])
        out = torch.stack(outs).cpu().numpy()
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1000
        self.perf.n_decode += n_steps * len(act_idx)
        for b in act_idx:
            self._pos_host[b, frees[b]] = np.arange(
                int(self.n_past[b]), int(self.n_past[b]) + n_steps
            )
            self.n_past[b] += n_steps
        return out

    def decode_multi(self, chunks: list) -> dict:
        """Process token chunks for SEVERAL sequences in one step (the
        server's packed prompt batch). chunks: [(seq_id, tokens)]; lengths
        may differ (bucketed + padded to one T). Returns {seq_id: last-token
        logits (n_vocab,)}."""
        if not chunks:
            return {}
        B = self.p.n_seqs
        S = self._S
        Tb = _bucket(max(len(t) for _, t in chunks))
        tokens = np.zeros((B, Tb), np.int32)
        pos = np.full((B, Tb), -1, np.int32)
        slots = np.full((B, Tb), S - 1, np.int32)
        last_idx = np.zeros(B, np.int32)
        n_new = 0
        for seq_id, toks in chunks:
            toks = np.asarray(toks, np.int32)
            T = len(toks)
            n_past = int(self.n_past[seq_id])
            if n_past + T > self.p.n_ctx:
                raise ValueError(
                    f"context overflow on seq {seq_id}: {n_past}+{T} > "
                    f"n_ctx={self.p.n_ctx}"
                )
            free = np.nonzero(self._pos_host[seq_id, : S - 1] < 0)[0]
            if len(free) < T:
                raise ValueError(f"no free KV cells on seq {seq_id}")
            tokens[seq_id, :T] = toks
            rng = np.arange(n_past, n_past + T, dtype=np.int32)
            pos[seq_id, :T] = rng
            slots[seq_id, :T] = free[:T]
            self._pos_host[seq_id, free[:T]] = rng
            last_idx[seq_id] = T - 1
            self.n_past[seq_id] = n_past + T
            n_new += T
        t0 = time.perf_counter()
        logits = self._forward(self.kv_k, self.kv_v, self.kv_pos, self._t(tokens),
                               self._t(pos), self._t(slots),
                               logit_rows=self._t(last_idx)[:, None])
        out = logits[:, 0].cpu().numpy()
        self.perf.t_prefill_ms += (time.perf_counter() - t0) * 1000
        self.perf.n_prefill += n_new
        return {seq_id: out[seq_id] for seq_id, _ in chunks}

    # ------------------------------------------------------- seq ops

    def seq_rm(self, p0: int, p1: int, seq_id: int = 0):
        """Remove positions [p0, p1) from a sequence (llama_memory_seq_rm)."""
        if p1 < 0:
            p1 = 1 << 30
        row = self.kv_pos[seq_id]
        row.masked_fill_((row >= p0) & (row < p1), -1)
        h = self._pos_host[seq_id]
        h[(h >= p0) & (h < p1)] = -1
        if p1 >= int(self.n_past[seq_id]):
            self.n_past[seq_id] = min(int(self.n_past[seq_id]), p0)

    def rollback_to(self, position: int, seq_id: int = 0):
        """Drop all cache entries at positions >= position."""
        self.seq_rm(position, -1, seq_id=seq_id)
        self.n_past[seq_id] = min(int(self.n_past[seq_id]), position)

    def reset(self, seq_id: int | None = None):
        if seq_id is None:
            self.kv_pos.fill_(-1)
            self._pos_host[:] = -1
            self.n_past[:] = 0
        else:
            self.kv_pos[seq_id].fill_(-1)
            self._pos_host[seq_id] = -1
            self.n_past[seq_id] = 0

    def memory_breakdown(self) -> dict:
        """Device bytes of the weights and the KV cache."""
        return {
            "weights": self.model.nbytes(),
            "kv_cache": self.kv_k.numel() * self.kv_k.element_size()
            + self.kv_v.numel() * self.kv_v.element_size(),
        }

    # ------------------------------------------------------- generate

    def generate(self, prompt_tokens, n_predict: int = 32, sampler=None) -> list[int]:
        """Greedy/sampled generation loop for sequence 0 (host sampler
        chain; the fused on-device burst of the JAX package waits for
        CUDA graphs)."""
        out: list[int] = []
        logits = self.decode(np.asarray(prompt_tokens, np.int32), n_logits=1)[-1]
        vocab = self.model.vocab
        for _ in range(n_predict):
            if sampler is None:
                tok = int(np.argmax(logits))
            else:
                tok = sampler.sample(logits)
            out.append(tok)
            if vocab is not None and vocab.is_eog(tok):
                break
            logits = self.decode(np.asarray([tok], np.int32), n_logits=1)[-1]
        return out


def make_context(model: LoadedModel, params: ContextParams | None = None, **kw) -> Context:
    """Context factory (the JAX package's runtime make_context): an
    attention model gets the KV-cache Context; `kw` goes to it. The
    recurrent, hybrid, encoder and seq2seq contexts are not ported yet
    (ROADMAP.md Queue 1 item 7): such an arch is refused by name
    (check_supported), and so is a multi-device mode (item 10)."""
    check_supported(model.hparams)
    if params is not None and params.parallel:
        raise NotImplementedError(
            f"parallel={params.parallel!r}: the multi-device modes are not ported yet "
            "(ROADMAP.md Queue 1 item 10)")
    return Context(model, params, **kw)
