"""Decode engine: KV cache + prefill/decode steps (port of
tpullama/runtime/context.py:Context for the plain llama family).

The cache is HEAD-MAJOR (L, B, Hkv, S, D), one lane per sequence (the
reference's per-stream layout), with S = n_ctx + 1 scratch cell rounded
up to a multiple of 128. With kv_dtype=torch.int8 each of kv_k and kv_v
is a (values, scales) pair, int8 (L, B, Hkv, S, D) rows and f32 (L, B,
Hkv, S) per-(head, token) scales, as the JAX package's {"q", "s"} cache:
the model quantizes each row on write and attention reads both. Sequence
positions live twice: `kv_pos` (B, S) on the device (-1 = empty cell),
from which each step builds its additive mask, and `_pos_host`, the host
mirror the free-cell allocator reads.

The iswa two-stack cache (the JAX package's, src/llama-kv-cache-iswa.h):
a model with both sliding-window and full layers (hp.swa_layers, gpt-oss)
keeps its SWA layers in a ring of S_swa = n_swa + min(n_ubatch, n_ctx) + 1
cells instead of S, when that is smaller and swa_full is off. kv_k, kv_v
and kv_pos are then {"full": ..., "swa": ...}: the full layers' (L_full,
B, Hkv, S, D) stack with its (B, S) positions, and the ring's (L_swa, B,
Hkv, S_swa, D) with its (B, S_swa) positions (int8: pairs on both). A
token at position p takes ring cell p % (S_swa - 1), padding (p < 0) the
scratch cell S_swa - 1, so the ring needs no allocator: `_pos_host`
mirrors the full stack alone, as in the JAX package. Each forward writes
at most n_ubatch new rows (longer prompts go in n_ubatch chunks), so no
cell a query's window needs is overwritten. The full layers attend with
the causal mask over the full stack, the SWA layers with the windowed one
(kp > p - n_swa) over the ring, or for llama4's chunked layers the
chunked one (kp >= (p // n_swa) * n_swa: a key is visible from its own
chunk of n_swa positions on); a single-stack model with SWA layers takes
the same mask pair over its one stack.

Every one-token decode step (decode at T == 1, decode_batch, and each
step of decode_burst and decode_batch_burst) is one step program over a
range of cache lanes (_StepProgram): it reads tokens, positions and the
active flags from one static int32 buffer, picks each active lane's first
free cell on the device, runs the model, and feeds its argmax (or a
device_sample draw) back into that buffer and into a ring of ids. On a
CUDA device each program is captured once as a CUDA graph, at its first
use, and every step replays it: the counterpart of the JAX package's
jax.jit step programs and its lax.scan bursts. On the CPU the same eager
step (Context._step) runs. Prefill (T > 1, decode_multi) stays eager.

Differences from the JAX package, by design:
  - the cache is written in place (models/llama.py scatter_rows) instead
    of being donated and returned by a jitted program;
  - a per-sequence step runs on views of that sequence's cache lane;
  - a burst is K replays of the step's graph (one host read at the end)
    instead of one scanned program; it returns the same ids and keeps the
    same host bookkeeping;
  - the sampled burst draws from a torch.Generator, not a threefry key
    (runtime/sampling.device_sample);
  - seq_add / seq_div / seq_cp write the lane and its positions in place
    (the graphs read them at fixed addresses), and their K re-rotation
    divides by the model's rope_freqs as the forward pass does, where the
    JAX package's _rotate leaves them out (only a model that carries
    rope_freqs, Llama-3.x and llama4, differs); each layer's K rows
    re-rotate with the rope table its forward takes: an SWA layer's with
    the SWA layers' own (rope_freq_base_swa; gemma3's unscaled), in the
    ring or in one stack, and a layer without rope (cohere2's full layers,
    smollm3's and llama4's NoPE layers) not at all, where the JAX package
    rotates every layer with the full layers' table (equal for gpt-oss and
    gemma2; ROADMAP.md Queue 3 item 12);
  - a prompt longer than n_ubatch on a two-stack cache goes in chunks that
    also return the hidden states of every chunk (embeddings), where the
    JAX package keeps the last chunk's;
  - a model with a learned position table (gpt2, starcoder) refuses an
    n_ctx above its rows, where the JAX package runs on and its positions
    past the table give NaN logits (ROADMAP.md Queue 3 item 14).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..models.hparams import HParams
from ..models.llama import LlamaModel, quantize_q8
from ..models.loader import LoadedModel, check_supported
from ..ops.cuda import add_launch_counts, launch_counts
from ..ops.rope import apply_rope, rope_cache
from .sampling import as_device_spec, device_sample

NEG_INF = -1e30  # avoids NaN rows for fully-masked (padded) queries
RING = 64  # rows of a step program's id ring: a burst reads it every RING steps


@dataclass
class ContextParams:
    """llama_context_default_params analog."""

    n_ctx: int = 512  # per sequence
    n_batch: int = 2048
    n_ubatch: int = 512
    n_seqs: int = 1
    dtype: torch.dtype = torch.float32
    # default: same as dtype; torch.int8: the quantized cache (values +
    # per-(head, token) f32 scales)
    kv_dtype: torch.dtype | None = None
    # True: SWA layers keep full n_ctx lanes (the reference's swa_full);
    # False: a ring of n_swa + n_ubatch + 1 cells where it is smaller
    swa_full: bool = False
    # multi-device mode ("pp" / "tp"): not ported yet, refused by make_context
    parallel: str | None = None


def _parts(cache) -> tuple:
    """A cache's tensors: the tensor, an int8 cache's values and scales, or
    those of both stacks of a two-stack cache."""
    if isinstance(cache, dict):
        return tuple(t for k in sorted(cache) for t in _parts(cache[k]))
    return cache if isinstance(cache, tuple) else (cache,)


def _lanes(cache, lanes: slice):
    """Lanes `lanes` of a stacked cache (axis 1): a view of the tensor, of
    both tensors of an int8 cache's (values, scales) pair, or of each
    stack of a two-stack cache."""
    if isinstance(cache, dict):
        return {k: _lanes(v, lanes) for k, v in cache.items()}
    if isinstance(cache, tuple):
        return tuple(t[:, lanes] for t in cache)
    return cache[:, lanes]


def _rows(kv_pos, lanes: slice):
    """Lanes `lanes` of the positions: a (B, S) view, or one per stack."""
    if isinstance(kv_pos, dict):
        return {k: v[lanes] for k, v in kv_pos.items()}
    return kv_pos[lanes]


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


class _StepProgram:
    """One one-token decode step over cache lanes [lo, hi) (n lanes): the
    static buffers it reads and writes, and on a CUDA device its captured
    graph. `inp` packs, as int32, each lane's input token, its next
    position, its active flag and one step counter: a caller fills it with
    one host-to-device copy. Each step writes the fed-back tokens into
    `tok` and into row step % RING of `ring`, adds the active flags to
    `npast` and one to the counter. `spec`: the device sampler of a
    sampled step (its seed is not part of the program; `gen` carries the
    draws), None for greedy."""

    def __init__(self, lo: int, hi: int, spec, device):
        n = hi - lo
        self.lo, self.hi, self.spec = lo, hi, spec
        self.inp = torch.zeros(3 * n + 1, dtype=torch.int32, device=device)
        self.tok = self.inp[:n].view(n, 1)
        self.npast = self.inp[n:2 * n]
        self.active = self.inp[2 * n:3 * n]
        self.step = self.inp[3 * n:]
        self.ring = torch.zeros((RING, n), dtype=torch.int32, device=device)
        self.gen = None if spec is None else torch.Generator(device=device)
        # set at capture: the graph, its (n, V) logits output, the launch
        # counts of one replay, the buffers it reads that the Python side
        # could drop (flash_decode's tickets), the capture's seconds and
        # the device memory it reserved
        self.graph = None
        self.logits = None
        self.launches: dict = {}
        self.keep: list = []
        self.capture_s = 0.0
        self.pool_bytes = 0

    def fill(self, tokens, n_past, active) -> None:
        """One host-to-device copy of the lanes' inputs; the counter at 0."""
        packed = np.concatenate([np.asarray(tokens, np.int32).reshape(-1),
                                 np.asarray(n_past, np.int32).reshape(-1),
                                 np.asarray(active, np.int32).reshape(-1),
                                 np.zeros(1, np.int32)])
        self.inp.copy_(torch.from_numpy(packed))


def _fold_in(seed: int, n: int) -> int:
    """A seed for chunk n of a sampled generate, from the spec's seed (the
    JAX package folds chunk n into its key)."""
    return int(np.random.SeedSequence([int(seed), int(n)]).generate_state(1, np.uint64)[0])


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
        pe = model.params.get("position_embd")
        if pe is not None and self.p.n_ctx > pe.shape[0]:
            # a learned position table (gpt2, starcoder) has a row for each
            # position: past it the JAX package's jnp.take gives NaN rows
            # (ROADMAP.md Queue 3 item 14), a CUDA gather a device assert
            raise ValueError(
                f"n_ctx={self.p.n_ctx} exceeds the model's learned position table "
                f"(position_embd) of {pe.shape[0]} rows")
        B = self.p.n_seqs
        S = -(-(self.p.n_ctx + 1) // 128) * 128
        self._S = S
        kv_dt = self.p.kv_dtype or self.p.dtype
        if not (kv_dt.is_floating_point or kv_dt == torch.int8):
            raise ValueError(f"kv_dtype {kv_dt}: the cache is a float type or torch.int8")
        Hkv, Dk, Dv = hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v

        def alloc(L, n_cells, D):
            # HEAD-MAJOR cache (L, B, Hkv, S, D): attention streams each
            # head's rows contiguously; the writer scatters its few rows.
            # int8: the rows and their f32 scales (L, B, Hkv, S), allocated
            # once, so the step graphs read them at fixed addresses
            rows = torch.zeros((L, B, Hkv, n_cells, D), dtype=kv_dt, device=self.device)
            if kv_dt != torch.int8:
                return rows
            return rows, torch.zeros(rows.shape[:-1], dtype=torch.float32, device=self.device)

        def positions(n_cells):
            return torch.full((B, n_cells), -1, dtype=torch.int32, device=self.device)

        # the iswa two-stack cache: both kinds of layer, swa_full off, and a
        # ring smaller than the full lanes (the JAX package's condition)
        n_swa_layers = sum(map(bool, hp.swa_layers))
        S_swa = hp.n_swa + min(self.p.n_ubatch, self.p.n_ctx) + 1
        self._S_swa = 0
        if (0 < n_swa_layers < hp.n_layer and not self.p.swa_full and hp.n_swa
                and S_swa < S):
            self._S_swa = S_swa
            L_full = hp.n_layer - n_swa_layers
            self.kv_k = {"full": alloc(L_full, S, Dk), "swa": alloc(n_swa_layers, S_swa, Dk)}
            self.kv_v = {"full": alloc(L_full, S, Dv), "swa": alloc(n_swa_layers, S_swa, Dv)}
            self.kv_pos = {"full": positions(S), "swa": positions(S_swa)}
        else:
            self.kv_k = alloc(hp.n_layer, S, Dk)
            self.kv_v = alloc(hp.n_layer, S, Dv)
            self.kv_pos = positions(S)
        self._pos_host = np.full((B, S), -1, np.int32)
        self.n_past = np.zeros(B, np.int32)
        self.perf = PerfCounters()
        self.net = LlamaModel(model.params, hp, model.quant_meta, fused_layer=fused_layer,
                              qmm_tile_k=qmm_tile_k)
        # one-token step programs by (lo, hi, spec), built at first use; on
        # a CUDA device their graphs share one memory pool (they never run
        # at once) and are captured on one side stream
        self._programs: dict = {}
        self._pool = None
        self._side = None

    # ------------------------------------------------------------------

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _forward(self, kv_k, kv_v, kv_pos, tokens, positions, slots, logit_rows=None,
                 return_embd: bool = False):
        """Shared core: record the new cells' positions (on a two-stack
        cache also the ring's, at each position's ring cell), build the
        additive mask (with SWA layers the pair of the causal mask and the
        windowed one; an ALiBi model's causal mask carries each visible
        cell's -|distance|), run the model (which writes K/V in place)."""
        B, T = tokens.shape
        b_ix = torch.arange(B, device=self.device)[:, None]
        slots_swa = None
        if isinstance(kv_pos, dict):
            Ss = self._S_swa
            slots_swa = torch.where(positions >= 0, positions % (Ss - 1), Ss - 1)
            kv_pos["swa"][b_ix, slots_swa.long()] = positions
            kp_full, kp_win = kv_pos["full"], kv_pos["swa"]
        else:
            kp_full = kp_win = kv_pos
        kp_full[b_ix, slots.long()] = positions
        q = positions[:, :, None]
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        neg = torch.full((), NEG_INF, dtype=torch.float32, device=self.device)

        def visible(kp):
            kp = kp[:, None, :]
            return (kp >= 0) & (kp <= q)

        vis = visible(kp_full)
        if self.hp.f_max_alibi_bias > 0.0:
            # ALiBi: a visible cell carries -|kv_pos - q_pos|, which attention
            # multiplies by each head's slope; a parked row (position -1)
            # sees no cell (tpullama/runtime/context.py:374-379)
            dist = (kp_full[:, None, :] - q).abs().to(torch.float32)
            mask = torch.where(vis, -dist, neg)[:, None]
        else:
            mask = torch.where(vis, zero, neg)[:, None]
        if self.net.swa and self.hp.n_swa:
            n_swa = self.hp.n_swa
            vis_w = vis if kp_win is kp_full else visible(kp_win)
            if self.hp.swa_type == "chunked":
                # llama4: visible from the query's chunk start on
                # (tpullama/runtime/context.py:380-397)
                start = torch.div(q, n_swa, rounding_mode="floor") * n_swa
                vis_w = vis_w & (kp_win[:, None, :] >= start)
            else:
                vis_w = vis_w & (kp_win[:, None, :] > q - n_swa)
            mask = (mask, torch.where(vis_w, zero, neg)[:, None])
        return self.net(tokens, positions, kv_k, kv_v, slots, mask, logit_rows=logit_rows,
                        return_embd=return_embd, cache_slots_swa=slots_swa)

    def _step_seq(self, seq: int, tokens, positions, slots, n_logits: int,
                  embd: bool = False):
        """Prefill/decode for ONE sequence on views of its cache lane.
        Returns its (n_logits, V) logits and, with `embd`, its (T, n_embd)
        final-norm hidden states (else None)."""
        T = tokens.shape[1]
        rows = torch.arange(T - n_logits, T, device=self.device)[None]
        lane = slice(seq, seq + 1)
        out = self._forward(
            _lanes(self.kv_k, lane), _lanes(self.kv_v, lane),
            _rows(self.kv_pos, lane), tokens, positions, slots, logit_rows=rows,
            return_embd=embd)
        logits, hidden = out if embd else (out, None)
        return logits[0], None if hidden is None else hidden[0]

    # ------------------------------------------------- one-token steps

    def _program(self, lo: int, hi: int, spec=None) -> _StepProgram:
        key = (lo, hi, None if spec is None else replace(spec, seed=0))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _StepProgram(lo, hi, key[2], self.device)
        return prog

    def _step(self, prog: _StepProgram) -> torch.Tensor:
        """The eager one-token step of `prog` (the CPU runs it; a CUDA graph
        captures it): every active lane writes its token at its first free
        cell (ascending, the host mirror's free-list order) and position
        npast; inactive lanes park on the scratch cell S - 1 with position
        -1 and echo their token (on a two-stack cache the ring's cells
        follow from the positions, the scratch cell S_swa - 1 for -1).
        Returns the (n, V) f32 logits."""
        lo, hi, S = prog.lo, prog.hi, self._S
        kv_pos = _rows(self.kv_pos, slice(lo, hi))
        kp_full = kv_pos["full"] if isinstance(kv_pos, dict) else kv_pos
        act = prog.active != 0
        free = torch.argmax((kp_full[:, : S - 1] < 0).to(torch.int32), dim=1).to(torch.int32)
        slots = torch.where(act, free, torch.full_like(free, S - 1))[:, None]
        pos = torch.where(act, prog.npast, torch.full_like(prog.npast, -1))[:, None]
        logits = self._forward(_lanes(self.kv_k, slice(lo, hi)), _lanes(self.kv_v, slice(lo, hi)),
                               kv_pos, prog.tok, pos, slots)[:, -1, :]
        if prog.spec is None:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            nxt = device_sample(logits[0], prog.gen, prog.spec).reshape(1)
        prog.tok.copy_(torch.where(act[:, None], nxt[:, None], prog.tok))
        prog.npast.add_(act.to(torch.int32))
        prog.ring.index_copy_(0, (prog.step % RING).long(), prog.tok.reshape(1, -1))
        prog.step.add_(1)
        return logits

    def _run(self, prog: _StepProgram) -> torch.Tensor:
        """One step of `prog` on its filled inputs: on a CUDA device a replay
        of its graph (captured at first use), on the CPU the eager step.
        Returns the (n, V) logits (on the card, the graph's output buffer)."""
        if self.device.type != "cuda":
            return self._step(prog)
        if prog.graph is None:
            self._capture(prog)
        prog.graph.replay()
        add_launch_counts(prog.launches)
        return prog.logits

    def _capture(self, prog: _StepProgram) -> None:
        """Capture prog's step as a CUDA graph in the Context's pool. First
        one eager step runs on the capture's side stream with every lane
        inactive (position -1, the scratch cell: no cache cell changes), so
        the kernel library, flash_decode's tickets and the kernels' static
        initialisers exist before capture; capture itself runs nothing. The
        inputs and the generator's state are put back as they were. The
        wrappers count their launches during capture: those counts are
        taken out here and added back at each replay. A failure raises."""
        from ..ops.cuda import flash_decode

        dev = self.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(dev)
        t0 = time.perf_counter()
        saved = prog.inp.clone()
        # the warm-up step draws from the generator: its state goes back after
        rng = None if prog.gen is None else prog.gen.get_state()
        prog.inp.zero_()
        cur = torch.cuda.current_stream(dev)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            self._step(prog)
        cur.wait_stream(self._side)
        graph = torch.cuda.CUDAGraph()
        if prog.gen is not None:
            graph.register_generator_state(prog.gen)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = launch_counts()
        # thread_local: the HTTP server steps the engine on its own thread
        with torch.cuda.graph(graph, pool=self._pool, stream=self._side,
                              capture_error_mode="thread_local"):
            logits = self._step(prog)
        after = launch_counts()
        prog.launches = {k: after[k] - v for k, v in before.items() if after[k] != v}
        add_launch_counts(prog.launches, -1)
        prog.keep = list(flash_decode._TICKETS.values())
        prog.logits, prog.graph = logits, graph
        prog.inp.copy_(saved)
        if rng is not None:
            prog.gen.set_state(rng)
        torch.cuda.synchronize(dev)
        prog.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        prog.capture_s = time.perf_counter() - t0

    def _burst(self, prog: _StepProgram, n_steps: int) -> np.ndarray:
        """n_steps steps of `prog` from its filled inputs, each feeding its
        tokens back on the device. Returns the (n_steps, n) ids, read from
        the ring once at the end (and every RING steps before it)."""
        rows = [np.zeros((0, prog.hi - prog.lo), np.int32)]
        for i in range(n_steps):
            self._run(prog)
            if i % RING == RING - 1 or i == n_steps - 1:
                rows.append(prog.ring[: i % RING + 1].cpu().numpy().copy())
        return np.concatenate(rows)

    # ------------------------------------------------------- decode APIs

    def decode(self, tokens: np.ndarray, n_logits: int = 1, seq_id: int = 0) -> np.ndarray:
        """Process tokens for one sequence. tokens: (T,) int.
        Returns logits (n_logits, n_vocab)."""
        return self._decode(tokens, n_logits, seq_id)[0]

    def _decode(self, tokens, n_logits: int, seq_id: int, embd: bool = False):
        """decode, also returning the final-norm hidden states of its T
        tokens ((T, n_embd) f32 on the device) when `embd` is set: then
        even a one-token step runs eagerly, since the step program's graph
        keeps no hidden states. Returns (logits, hidden states or None)."""
        tokens = np.asarray(tokens, np.int32).reshape(1, -1)
        _, T = tokens.shape
        n_past = int(self.n_past[seq_id])
        if n_past + T > self.p.n_ctx:
            raise ValueError(
                f"context overflow: {n_past}+{T} > n_ctx={self.p.n_ctx} "
                f"(use seq_rm / context shift)"
            )
        if self._S_swa and T > self.p.n_ubatch:
            # the ring holds n_swa + n_ubatch cells: a forward writes at most
            # n_ubatch new rows, so the prompt goes in n_ubatch chunks (the
            # way llama_decode splits a batch into ubatches)
            ub = self.p.n_ubatch
            pieces, hidden = [], []
            for st in range(0, T, ub):
                chunk = tokens[0, st:st + ub]
                need = min(max(0, n_logits - (T - st - len(chunk))), len(chunk))
                out, h = self._decode(chunk, max(1, need), seq_id, embd)
                if need:
                    pieces.append(out[-need:])
                hidden.append(h)
            return (np.concatenate(pieces, axis=0)[-n_logits:],
                    torch.cat(hidden) if embd else None)
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
        hidden = None
        if T == 1 and n_logits == 1 and not embd:
            # the lane's step program; its first free cell is srow's
            prog = self._program(seq_id, seq_id + 1)
            prog.fill(tokens[0], [n_past], [1])
            out = self._run(prog).cpu().numpy()
        else:
            # logits of the last n_logits real tokens (padding sits after them)
            logits, hidden = self._step_seq(seq_id, self._t(toks), self._t(pos),
                                            self._t(slots), n_logits + pad, embd)
            out = logits.cpu().numpy()
            hidden = None if hidden is None else hidden[:T]
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
        return out, hidden

    def _batch_inputs(self, tokens, active):
        """The host mirror's side of one batched step: each active lane's
        first free cell takes its next position (the step program picks the
        same cell on the device)."""
        B = self.p.n_seqs
        S = self._S
        tokens = np.asarray(tokens, np.int32).reshape(B)
        active = np.asarray(active, bool)
        for b in range(B):
            if active[b]:
                free = np.nonzero(self._pos_host[b, : S - 1] < 0)[0]
                if len(free) == 0:
                    raise ValueError(f"no free KV cells for seq {b}")
                self._pos_host[b, free[0]] = int(self.n_past[b])
        return tokens, active

    def decode_batch(self, tokens: np.ndarray, active: np.ndarray) -> np.ndarray:
        """One decode step for all sequences (continuous batching hot loop).
        tokens: (B,) int32, active: (B,) bool. Returns logits (B, n_vocab);
        inactive rows are garbage."""
        tokens, active = self._batch_inputs(tokens, active)
        prog = self._program(0, self.p.n_seqs)
        prog.fill(tokens, self.n_past, active)
        t0 = time.perf_counter()
        out = self._run(prog).cpu().numpy()
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
        prog = self._program(0, B)
        prog.fill(np.asarray(tokens, np.int32).reshape(B), self.n_past, active)
        t0 = time.perf_counter()
        out = self._burst(prog, n_steps)
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1000
        self.perf.n_decode += n_steps * len(act_idx)
        for b in act_idx:
            self._pos_host[b, frees[b]] = np.arange(
                int(self.n_past[b]), int(self.n_past[b]) + n_steps
            )
            self.n_past[b] += n_steps
        return out

    def decode_burst(self, first_token: int, n_steps: int, sampler_spec=None,
                     generator: torch.Generator | None = None) -> np.ndarray:
        """Decode n_steps tokens after first_token (seq 0, B=1) on the device,
        with one host read at the end: greedy, or with sampler_spec.temp > 0
        the device sampler (runtime/sampling.device_sample) inside each
        step. `generator` (on the Context's device) carries the draws and
        advances as they are made; without one they come from
        sampler_spec.seed. Returns the generated token ids; the cache
        advances by n_steps (first_token + generated[:-1])."""
        if self.p.n_seqs != 1:
            raise ValueError("decode_burst is single-sequence (B=1)")
        n_past = int(self.n_past[0])
        if n_past + n_steps + 1 > self.p.n_ctx:
            raise ValueError("context overflow for burst")
        free = np.nonzero(self._pos_host[0, : self._S - 1] < 0)[0]
        if len(free) < n_steps + 1:
            raise ValueError("no free KV cells for burst")
        sampled = sampler_spec is not None and sampler_spec.temp > 0
        prog = self._program(0, 1, sampler_spec if sampled else None)
        if sampled:
            if generator is None:
                prog.gen.manual_seed(int(sampler_spec.seed))
            else:
                prog.gen.set_state(generator.get_state())
        prog.fill([first_token], [n_past], [1])
        t0 = time.perf_counter()
        out = self._burst(prog, n_steps)[:, 0]
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1000
        self.perf.n_decode += n_steps
        if sampled and generator is not None:
            generator.set_state(prog.gen.get_state())
        # host mirrors: the burst consumed the first n_steps free cells with
        # positions n_past..n_past+n_steps-1 (the device picks them in the
        # host free list's order)
        self._pos_host[0, free[:n_steps]] = np.arange(n_past, n_past + n_steps)
        self.n_past[0] = n_past + n_steps
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
            if self._S_swa and T > self.p.n_ubatch:
                raise ValueError(
                    f"chunk of {T} tokens on seq {seq_id} exceeds n_ubatch={self.p.n_ubatch} "
                    "(small-SWA ring cache writes at most n_ubatch rows per step; "
                    "raise n_ubatch or use swa_full=True)")
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

    def embeddings(self, tokens, pooling: str = "mean", seq_id: int = 0,
                   normalize: bool = True) -> np.ndarray:
        """Embed a token sequence (llama_get_embeddings + pooling types
        NONE/MEAN/CLS/LAST; common_embd_normalize): the lane is reset and
        the tokens run eagerly (one token included) with the final-norm
        hidden states. Returns (n_embd,) for pooled types or (T, n_embd)
        for 'none'."""
        self.reset(seq_id)
        _, embd = self._decode(np.asarray(tokens, np.int32), 1, seq_id, embd=True)
        e = embd.cpu().numpy()
        if pooling == "none":
            out = e
        elif pooling == "mean":
            out = e.mean(axis=0)
        elif pooling == "cls":
            out = e[0]
        elif pooling == "last":
            out = e[-1]
        else:
            raise ValueError(f"unknown pooling {pooling!r}")
        if normalize and pooling != "none":
            n = np.linalg.norm(out)
            out = out / n if n > 0 else out
        return out

    # ------------------------------------------------------- seq ops
    # Each op writes the cache lane and its positions IN PLACE: the step
    # programs' CUDA graphs read kv_k, kv_v and kv_pos at fixed addresses.

    def _pos_stacks(self) -> list:
        """The (B, cells) positions of each stack, the full stack's first."""
        return list(self.kv_pos.values()) if isinstance(self.kv_pos, dict) else [self.kv_pos]

    def seq_rm(self, p0: int, p1: int, seq_id: int = 0):
        """Remove positions [p0, p1) from a sequence (llama_memory_seq_rm)."""
        if p1 < 0:
            p1 = 1 << 30
        for kp in self._pos_stacks():
            row = kp[seq_id]
            row.masked_fill_((row >= p0) & (row < p1), -1)
        h = self._pos_host[seq_id]
        h[(h >= p0) & (h < p1)] = -1
        if p1 >= int(self.n_past[seq_id]):
            self.n_past[seq_id] = min(int(self.n_past[seq_id]), p0)

    def _rope_kinds(self, stack: str | None) -> list:
        """Each layer of a cache stack ("full", "swa", or None for the one
        stack) by the rope its forward takes: "full" (the model's table),
        "swa" (the SWA layers' table), both with rope_freqs, or None (no
        rope: cohere2's full layers, a NoPE layer, an arch without rope)."""
        kinds = list(self.net.rope_kinds)
        if stack is None:
            return kinds
        swa = self.net.swa or (False,) * self.hp.n_layer
        return [k for k, s in zip(kinds, swa) if s == (stack == "swa")]

    def _rotate(self, stack: str | None, seq_id: int, deltas: torch.Tensor) -> None:
        """Re-rotate every cached K row of lane seq_id of a cache stack
        ("full", "swa", or None for the one stack) by its cell's position
        delta ((cells,) int), in f32, cast back to the cache dtype: R(pos +
        d) = R(d)·R(pos) per rope frequency. Each layer's rotation by d
        comes from the table its forward takes (rope_freqs and partial
        rotation included; an SWA layer's from the SWA layers' table; a
        layer without rope keeps its rows), so a YaRN model's mscale is
        applied again to every row of the lane, as in the JAX package. An
        int8 lane is dequantized, rotated and quantized again with fresh
        scales (rotation changes each row's amax), as there."""
        kv_k = self.kv_k if stack is None else self.kv_k[stack]
        kinds = self._rope_kinds(stack)
        for kind in ("full", "swa"):
            idx = [i for i, k in enumerate(kinds) if k == kind]
            if not idx:
                continue
            rp = self.net.rp_swa if kind == "swa" else self.net.rp
            cos, sin = rope_cache(rp, deltas, self.model.params.get("rope_freqs"))
            ix = torch.as_tensor(idx, device=self.device)
            if isinstance(kv_k, tuple):
                kq, ks = (t[:, seq_id] for t in kv_k)  # (L, Hkv, S, D), (L, Hkv, S)
                k = kq.index_select(0, ix).float() * ks.index_select(0, ix)[..., None]
                nq, ns = quantize_q8(apply_rope(k, cos[None, None], sin[None, None], rp.mode,
                                                rp.n_dims))
                kq.index_copy_(0, ix, nq)
                ks.index_copy_(0, ix, ns)
                continue
            k = kv_k[:, seq_id]  # (L, Hkv, S, D) view of the lane
            rotated = apply_rope(k.index_select(0, ix).float(), cos[None, None], sin[None, None],
                                 rp.mode, rp.n_dims)
            k.index_copy_(0, ix, rotated.to(k.dtype))

    def seq_add(self, p0: int, p1: int, delta: int, seq_id: int = 0):
        """Shift positions in [p0, p1) by delta (llama_memory_seq_add),
        re-rotating the cached K rows by the delta (the reference's lazy
        rope-shift graph applied eagerly). Cells are picked by masks over
        the lane, so p1 may be as large as 2**30. On a two-stack cache the
        ring's shifted rows also move to their new positions' cells, the
        newest position winning a cell (the losers are a ring's length
        older, outside any later window): the JAX package's host loop."""
        row = self._pos_stacks()[0][seq_id]  # the full stack's
        deltas = torch.where((row >= p0) & (row < p1), delta, 0).to(torch.int32)
        two = isinstance(self.kv_k, dict)
        self._rotate("full" if two else None, seq_id, deltas)
        row.add_(deltas)
        if two:
            R = self._S_swa
            srow = self.kv_pos["swa"][seq_id]
            old = srow.cpu().numpy()
            srng = (old >= p0) & (old < p1)
            self._rotate("swa", seq_id, self._t(np.where(srng, delta, 0).astype(np.int32)))
            new_pos = np.where(srng, old + delta, old)
            src = np.full(R, -1, np.int64)
            posf = np.full(R, -1, np.int32)
            for i in np.argsort(new_pos, kind="stable"):  # newest wins
                if new_pos[i] >= 0:
                    cell = int(new_pos[i]) % (R - 1)
                    src[cell] = i
                    posf[cell] = new_pos[i]
            gather = self._t(np.maximum(src, 0))
            for t in _parts(self.kv_k["swa"]) + _parts(self.kv_v["swa"]):
                lane = t[:, seq_id]  # (L, Hkv, S_swa[, D])
                lane.copy_(lane.index_select(2, gather))
            srow.copy_(self._t(posf))
        h = self._pos_host[seq_id]
        h[(h >= p0) & (h < p1)] += delta
        if p1 >= int(self.n_past[seq_id]) >= p0:
            self.n_past[seq_id] = int(self.n_past[seq_id]) + delta

    def seq_div(self, p0: int, p1: int, d: int, seq_id: int = 0):
        """Integer-divide positions in [p0, p1) by d (llama_memory_seq_div,
        the self-extend primitive). Cached K is re-rotated by (new_pos -
        old_pos) per cell. n_past stays, as in the JAX package. A ring's
        cells are its positions' residues, which a division would remap:
        refused there, as in the JAX package."""
        if isinstance(self.kv_pos, dict):
            raise RuntimeError(
                "seq_div (self-extend) requires swa_full=True with an iswa small cache")
        row = self.kv_pos[seq_id]
        new_row = torch.where((row >= p0) & (row < p1),
                              torch.div(row, d, rounding_mode="floor"), row)
        self._rotate(None, seq_id, (new_row - row).to(torch.int32))
        row.copy_(new_row)
        h = self._pos_host[seq_id]
        sel = (h >= p0) & (h < p1)
        h[sel] = h[sel] // d

    def seq_cp(self, src: int, dst: int):
        """Copy a sequence's cache lane to another (llama_memory_seq_cp)."""
        for t in _parts(self.kv_k) + _parts(self.kv_v):
            t[:, dst].copy_(t[:, src])
        for kp in self._pos_stacks():
            kp[dst].copy_(kp[src])
        self._pos_host[dst] = self._pos_host[src]
        self.n_past[dst] = self.n_past[src]

    def rollback_to(self, position: int, seq_id: int = 0):
        """Drop all cache entries at positions >= position."""
        self.seq_rm(position, -1, seq_id=seq_id)
        self.n_past[seq_id] = min(int(self.n_past[seq_id]), position)

    def reset(self, seq_id: int | None = None):
        for kp in self._pos_stacks():
            (kp if seq_id is None else kp[seq_id]).fill_(-1)
        if seq_id is None:
            self._pos_host[:] = -1
            self.n_past[:] = 0
        else:
            self._pos_host[seq_id] = -1
            self.n_past[seq_id] = 0

    def memory_breakdown(self) -> dict:
        """Device bytes of the weights and the KV cache (an int8 cache's
        values and scales); a two-stack cache's full and SWA layers also
        apart."""
        def nbytes(*caches):
            return sum(t.numel() * t.element_size() for c in caches for t in _parts(c))

        out = {"weights": self.model.nbytes(), "kv_cache": nbytes(self.kv_k, self.kv_v)}
        if isinstance(self.kv_k, dict):
            out["kv_cache_full_layers"] = nbytes(self.kv_k["full"], self.kv_v["full"])
            out["kv_cache_swa_layers"] = nbytes(self.kv_k["swa"], self.kv_v["swa"])
        return out

    # ------------------------------------------------------- generate

    def generate(self, prompt_tokens, n_predict: int = 32, sampler=None,
                 burst: int = 0) -> list[int]:
        """Greedy/sampled generation loop (tools/main/main.cpp:685-716
        analog), sequence 0. With burst > 1, greedy sampling or a chain the
        device sampler covers (as_device_spec), and one sequence, decodes
        in on-device chunks of `burst` tokens (decode_burst: one host read
        per chunk; an EOG truncates the chunk and rolls the cache back).
        A sampled chunk n draws from a generator seeded from the spec's
        seed and n. Any other chain runs the host loop."""
        out: list[int] = []
        logits = self.decode(np.asarray(prompt_tokens, np.int32), n_logits=1)[-1]
        vocab = self.model.vocab
        spec = None
        if sampler is not None and burst > 1:
            spec = as_device_spec(sampler)  # None -> host chain fallback
        if (sampler is None or spec is not None) and burst > 1 and self.p.n_seqs == 1:
            sampled = spec is not None and spec.temp > 0
            tok = int(sampler.sample(logits)) if sampled else int(np.argmax(logits))
            out.append(tok)
            n_chunk = 0
            while len(out) < n_predict and not (vocab is not None and vocab.is_eog(tok)):
                n = min(burst, n_predict - len(out),
                        self.p.n_ctx - int(self.n_past[0]) - 1)
                if n < 1:
                    break
                gen = None
                if sampled:
                    gen = torch.Generator(device=self.device).manual_seed(
                        _fold_in(spec.seed, n_chunk))
                n_chunk += 1
                chunk = self.decode_burst(tok, n, sampler_spec=spec, generator=gen).tolist()
                eog_at = None
                if vocab is not None:
                    for i, t in enumerate(chunk):
                        if vocab.is_eog(t):
                            eog_at = i
                            break
                if eog_at is not None:
                    kept = chunk[: eog_at + 1]
                    # drop cache rows written by tokens after the EOG
                    self.rollback_to(int(self.n_past[0]) - (len(chunk) - len(kept)))
                    out += kept
                    return out[:n_predict]
                out += chunk
                tok = chunk[-1]
            return out[:n_predict]
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
