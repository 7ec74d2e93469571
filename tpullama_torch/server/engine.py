"""Continuous-batching slot engine (port of tpullama/server/engine.py).

Slots own one sequence lane each in a shared multi-sequence Context;
every engine iteration
  1. assigns queued tasks to idle slots (with prompt-prefix reuse),
  2. advances the prompt-processing slots by one n_ubatch chunk, packed
     into one step when several slots are prompting,
  3. runs ONE batched decode step for all generating slots (or a greedy
     burst of K steps when every generating slot is greedy and nothing
     waits), samples per slot, handles stop conditions and streaming.

The port builds the attention Context directly; recurrent, hybrid and
encoder models, speculative decoding, multimodal chunks, embeddings
tasks, grammar-constrained sampling and slot save/restore are not ported
yet.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

import numpy as np
import torch

from ..models.loader import check_supported
from ..runtime.context import Context, ContextParams
from ..runtime.sampling import SamplerChain


class SlotState(Enum):
    IDLE = "idle"
    PROMPT = "processing_prompt"
    GENERATING = "generating"


@dataclass
class Task:
    prompt_tokens: list
    n_predict: int = 128
    sampler: SamplerChain | None = None
    stop: list = field(default_factory=list)  # stop strings
    stream_queue: Optional[queue.Queue] = None
    id: int = 0
    # results
    done: threading.Event = field(default_factory=threading.Event)
    out_tokens: list = field(default_factory=list)
    out_text: str = ""
    stop_reason: str = ""
    stop_word: str = ""  # the matched stop string, if stop_reason=="stop"
    error: str = ""
    t_start: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    @property
    def ttft_ms(self) -> float:
        return (self.t_first_token - self.t_start) * 1000 if self.t_first_token else 0.0


@dataclass
class Slot:
    id: int
    state: SlotState = SlotState.IDLE
    task: Optional[Task] = None
    n_prompt_done: int = 0
    cache_tokens: list = field(default_factory=list)  # tokens in this seq's KV
    pending_text: str = ""  # holdback buffer for stop-string matching
    last_token: int = 0


class ServerEngine:
    def __init__(self, model, n_slots: int = 4, n_ctx: int = 1024, n_ubatch: int = 256,
                 dtype=None, burst: int = 8, fused_layer: bool | None = None,
                 qmm_tile_k: int | None = None):
        """`burst`: widest fused greedy decode round (0 or 1 disables; the
        JAX package's TPULLAMA_ENGINE_BURST default of 8). `fused_layer`
        and `qmm_tile_k` go to the Context's model (default: the
        TPULLAMA_FUSED_LAYER and TPULLAMA_QMM_TILE_K variables)."""
        # the port's HParams hold the llama family only, so this also refuses
        # the models that need the recurrent, hybrid or encoder contexts
        check_supported(model.hparams)
        self.model = model
        self.vocab = model.vocab
        cp = ContextParams(n_ctx=n_ctx, n_seqs=n_slots, n_ubatch=n_ubatch,
                           dtype=dtype or torch.float32)
        self.ctx = Context(model, cp, fused_layer=fused_layer, qmm_tile_k=qmm_tile_k)
        self.n_ubatch = n_ubatch
        self.burst = int(burst)
        self.slots = [Slot(i) for i in range(n_slots)]
        self.queue: "queue.Queue[Task]" = queue.Queue()
        self._control_queue: "queue.Queue[Callable[[], None]]" = queue.Queue()
        self._task_counter = 0
        self._lock = threading.Lock()
        self._stop_flag = False
        self._thread: Optional[threading.Thread] = None
        self.metrics = {
            "n_prompt_tokens_processed": 0,
            "n_tokens_predicted": 0,
            "n_requests": 0,
            "n_errors": 0,
        }

    # ------------------------------------------------------------- API

    def submit(self, task: Task) -> Task:
        with self._lock:
            self._task_counter += 1
            task.id = self._task_counter
        task.t_start = time.perf_counter()
        self.metrics["n_requests"] += 1
        self.queue.put(task)
        return task

    def start(self):
        self._stop_flag = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop_flag = True
        if self._thread:
            self._thread.join(timeout=30)
            self._thread = None

    def busy(self) -> bool:
        return any(s.state != SlotState.IDLE for s in self.slots) or not self.queue.empty()

    def control(self, fn: Callable[[], object], timeout: float = 600):
        """Run fn() on the engine thread between iterations; return its
        result (or raise its exception)."""
        if self._thread is None:
            return fn()  # synchronous mode
        done = threading.Event()
        box: dict = {}

        def wrapper():
            try:
                box["result"] = fn()
            except Exception as e:  # propagated to the caller
                box["error"] = e
            done.set()

        self._control_queue.put(wrapper)
        if not done.wait(timeout):
            raise TimeoutError("engine control op timed out")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def slot_erase(self, slot_id: int) -> dict:
        def op():
            if not 0 <= slot_id < len(self.slots):
                raise IndexError(f"invalid slot id {slot_id}")
            slot = self.slots[slot_id]
            if slot.state != SlotState.IDLE:
                raise RuntimeError("slot is busy; cannot erase")
            n = len(slot.cache_tokens)
            slot.cache_tokens = []
            self.ctx.reset(slot_id)
            return {"id_slot": slot_id, "n_erased": n}

        return self.control(op)

    # ------------------------------------------------------------ loop

    def _loop(self):
        while not self._stop_flag:
            worked = self.step()
            if not worked:
                time.sleep(0.002)

    def step(self) -> bool:
        """One update_slots iteration. Returns True if any work happened."""
        worked = False
        while True:
            try:
                ctl = self._control_queue.get_nowait()
            except queue.Empty:
                break
            ctl()
            worked = True
        worked = self._assign_tasks() or worked
        worked = self._process_prompts() or worked
        worked = self._decode_step() or worked
        return worked

    def _assign_tasks(self) -> bool:
        worked = False
        for slot in self.slots:
            if slot.state != SlotState.IDLE:
                continue
            try:
                task = self.queue.get_nowait()
            except queue.Empty:
                break
            prompt = list(task.prompt_tokens)
            if len(prompt) >= self.ctx.p.n_ctx:
                task.error = f"prompt too long ({len(prompt)} >= n_ctx {self.ctx.p.n_ctx})"
                self.metrics["n_errors"] += 1
                task.done.set()
                if task.stream_queue is not None:
                    task.stream_queue.put(None)
                continue
            # prompt-cache reuse: keep the common prefix with the previous
            # request on this slot
            common = 0
            for a, b in zip(slot.cache_tokens, prompt):
                if a != b:
                    break
                common += 1
            # always recompute at least the last prompt token (to get logits)
            common = min(common, len(prompt) - 1)
            if common > 0:
                if int(self.ctx.n_past[slot.id]) != common:
                    self.ctx.seq_rm(common, -1, seq_id=slot.id)
                    self.ctx.n_past[slot.id] = common
                self.ctx.perf.n_reused += common
            else:
                self.ctx.reset(slot.id)
            slot.task = task
            slot.n_prompt_done = common
            slot.cache_tokens = prompt[:common]
            slot.pending_text = ""
            slot.state = SlotState.PROMPT
            worked = True
        return worked

    def _process_prompts(self) -> bool:
        """Advance every prompt-processing slot by one n_ubatch chunk,
        packed into a single step when several slots are prompting."""
        text_slots = [s for s in self.slots if s.state == SlotState.PROMPT]
        if not text_slots:
            return False
        batch = []
        if len(text_slots) == 1:
            slot = text_slots[0]
            prompt = slot.task.prompt_tokens
            chunk = prompt[slot.n_prompt_done : slot.n_prompt_done + self.n_ubatch]
            logits = {slot.id: self.ctx.decode(
                np.asarray(chunk, np.int32), n_logits=1, seq_id=slot.id
            )[-1]}
            batch = [(slot, len(chunk))]
        else:
            chunks = []
            for slot in text_slots:
                prompt = slot.task.prompt_tokens
                chunk = prompt[slot.n_prompt_done : slot.n_prompt_done + self.n_ubatch]
                chunks.append((slot.id, chunk))
                batch.append((slot, len(chunk)))
            logits = self.ctx.decode_multi(chunks)
        for slot, n in batch:
            slot.n_prompt_done += n
            slot.cache_tokens = list(slot.task.prompt_tokens[: slot.n_prompt_done])
            self.metrics["n_prompt_tokens_processed"] += n
            if slot.n_prompt_done >= len(slot.task.prompt_tokens):
                tok = self._sample(slot, logits[slot.id])
                if not self._emit(slot, tok):
                    continue
                slot.state = SlotState.GENERATING
        return True

    def _decode_step(self) -> bool:
        gen = [s for s in self.slots if s.state == SlotState.GENERATING]
        if not gen:
            return False
        B = len(self.slots)
        tokens = np.zeros(B, np.int32)
        active = np.zeros(B, bool)
        for s in gen:
            tokens[s.id] = s.last_token
            active[s.id] = True
        if any(int(self.ctx.n_past[s.id]) + 1 > self.ctx.p.n_ctx for s in gen):
            for s in gen:
                if int(self.ctx.n_past[s.id]) + 1 > self.ctx.p.n_ctx:
                    self._finish(s, "length")
            return True
        K = self._burst_len(gen)
        if K > 1:
            return self._burst_decode(gen, tokens, active, K)
        logits = self.ctx.decode_batch(tokens, active)
        for s in gen:
            self._emit(s, self._sample(s, logits[s.id]))
        return True

    def _burst_len(self, gen) -> int:
        """Burst width for this decode round, or 1 for the one-step path.
        Bursting is legal when every generating slot samples pure-greedy,
        has already emitted its first token, and no prompt
        work is waiting. Width: largest power of two <= every slot's
        remaining budget, capped by `burst`."""
        cap = self.burst
        if cap <= 1 or not self.queue.empty():
            return 1
        for s in self.slots:
            if s.state == SlotState.PROMPT:
                return 1
        room = cap
        for s in gen:
            t = s.task
            if t.sampler is not None:
                return 1
            if not t.t_first_token:
                return 1
            room = min(room,
                       t.n_predict - len(t.out_tokens),
                       self.ctx.p.n_ctx - int(self.ctx.n_past[s.id]))
        if room < 2:
            return 1
        K = 1
        while K * 2 <= room:
            K *= 2
        return min(K, cap)

    def _burst_decode(self, gen, tokens, active, K: int) -> bool:
        """Run K greedy steps on the device, then emit on the host. A slot
        that stops mid-burst (EOG / stop string / n_predict) rolls its KV
        tail back to the last emitted token."""
        past0 = {s.id: int(self.ctx.n_past[s.id]) for s in gen}
        out = self.ctx.decode_batch_burst(tokens, active, K)  # (K, B)
        for s in gen:
            done_at = None
            for j in range(K):
                if not self._emit(s, int(out[j, s.id])):
                    done_at = j
                    break
            if done_at is not None and done_at < K - 1:
                # inputs were written through position past0+K-1; valid
                # prefix ends at past0+done_at (input = last emitted tok)
                self.ctx.rollback_to(past0[s.id] + done_at + 1, seq_id=s.id)
        return True

    # ------------------------------------------------------- helpers

    def _sample(self, slot: Slot, logits: np.ndarray) -> int:
        task = slot.task
        if task.sampler is None:
            return int(np.argmax(logits))
        return task.sampler.sample(logits)

    def _emit(self, slot: Slot, tok: int) -> bool:
        """Record a sampled token; returns False if the slot finished."""
        task = slot.task
        if not task.t_first_token:
            task.t_first_token = time.perf_counter()
        if self.vocab.is_eog(tok):
            self._finish(slot, "stop")
            return False
        task.out_tokens.append(tok)
        slot.cache_tokens.append(tok)
        slot.last_token = tok
        self.metrics["n_tokens_predicted"] += 1
        piece = self.vocab.token_to_piece(tok, special=False)
        slot.pending_text += piece
        # stop-string scan with holdback of possible partial matches
        emit_now = slot.pending_text
        for stop in task.stop:
            idx = slot.pending_text.find(stop)
            if idx >= 0:
                task.out_text += slot.pending_text[:idx]
                if task.stream_queue is not None and slot.pending_text[:idx]:
                    task.stream_queue.put(slot.pending_text[:idx])
                task.stop_word = stop
                self._finish(slot, "stop", flush=False)
                return False
            for k in range(min(len(stop) - 1, len(emit_now)), 0, -1):
                if stop.startswith(emit_now[-k:]):
                    emit_now = emit_now[:-k]
                    break
        if task.stop:
            flush = emit_now
            slot.pending_text = slot.pending_text[len(flush):]
        else:
            flush = slot.pending_text
            slot.pending_text = ""
        if flush:
            task.out_text += flush
            if task.stream_queue is not None:
                task.stream_queue.put(flush)
        if len(task.out_tokens) >= task.n_predict:
            self._finish(slot, "length")
            return False
        return True

    def _finish(self, slot: Slot, reason: str, flush: bool = True):
        task = slot.task
        if flush and slot.pending_text:
            task.out_text += slot.pending_text
            if task.stream_queue is not None:
                task.stream_queue.put(slot.pending_text)
        slot.pending_text = ""
        task.stop_reason = reason
        task.t_done = time.perf_counter()
        task.done.set()
        if task.stream_queue is not None:
            task.stream_queue.put(None)  # sentinel: stream end
        slot.task = None
        slot.state = SlotState.IDLE

    # ------------------------------------------------------- sync API

    def complete(self, prompt: str, n_predict: int = 64, sampler=None, stop=None,
                 timeout: float = 600.0) -> Task:
        toks = self.vocab.tokenize(prompt, add_special=True)
        task = Task(prompt_tokens=toks, n_predict=n_predict, sampler=sampler,
                    stop=stop or [])
        self.submit(task)
        if self._thread is None:
            while not task.done.is_set():
                self.step()
        else:
            task.done.wait(timeout)
        return task
