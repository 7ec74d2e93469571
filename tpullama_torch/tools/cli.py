"""llama-cli analog: single-shot and interactive generation (port of
tpullama/tools/cli.py).

Flag names mirror the reference's arg system (common/arg.cpp) for the
subset implemented; env-var mirrors use the same LLAMA_ARG_* names. The
model runs on the CUDA card unless --device cpu asks for the plain
PyTorch path.

--grammar / --grammar-file / --json-schema / --json-schema-file constrain
sampling (runtime/grammar.py, runtime/json_schema.py), --model-draft
decodes speculatively with a draft model (runtime/speculative.py), and
--prompt-cache FILE restores the context state before generating and
saves it after (unless restored or --prompt-cache-ro; runtime/state.py),
as in the JAX package. Not ported yet, and refused by name when set:
control vectors, LoRA adapters, n-gram lookup decoding (ROADMAP.md Queue 1
item 6) and the multi-card split modes (item 10).

Usage:
  python -m tpullama_torch.tools.cli -m model.gguf -p "prompt" -n 64 --temp 0
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# flags whose feature is not ported yet: (argparse dest, flag, what, ROADMAP.md
# Queue 1 item); a flag left at its default trips nothing
_UNPORTED = (
    ("control_vector", "--control-vector", "control vectors", 6),
    ("control_vector_scaled", "--control-vector-scaled", "control vectors", 6),
    ("control_vector_layer_range", "--control-vector-layer-range", "control vectors", 6),
    ("lora", "--lora", "LoRA adapters", 6),
    ("lookup_cache_static", "--lookup-cache-static", "n-gram lookup decoding", 6),
    ("lookup_cache_dynamic", "--lookup-cache-dynamic", "n-gram lookup decoding", 6),
)


def build_parser() -> argparse.ArgumentParser:
    from .args import build_parser as common_parser

    ap = common_parser("cli", prog="tpullama-cli", description=__doc__)
    ap.add_argument("-i", "--interactive", action="store_true")
    ap.add_argument("--burst", type=int, default=16,
                    help="greedy decode chunk size for fused on-device steps")
    return ap


def refuse_unported(args) -> None:
    """Raise NotImplementedError naming the first flag set whose feature is
    not ported yet (--split-mode other than none included)."""
    for dest, flag, what, item in _UNPORTED:
        if getattr(args, dest, None):
            raise NotImplementedError(
                f"{flag}: {what} is not ported yet (ROADMAP.md Queue 1 item {item})")
    if getattr(args, "split_mode", "none") != "none":
        raise NotImplementedError(
            f"--split-mode {args.split_mode}: the multi-card split modes are not "
            "ported yet (ROADMAP.md Queue 1 item 10)")


def _unescape(t: str) -> str:
    r"""string_process_escapes (common/common.cpp): \n \t \' \" \\ \xNN."""
    return t.encode("utf-8").decode("unicode_escape").encode(
        "latin-1").decode("utf-8")


def main(argv=None) -> int:
    if "--list-devices" in (argv if argv is not None else sys.argv[1:]):
        import torch

        for i in range(torch.cuda.device_count()):
            print(f"{i}: cuda:{i} {torch.cuda.get_device_name(i)}")
        return 0
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    if getattr(args, "color", False) and sys.stdout.isatty():
        _c0, _c1 = "\033[33m", "\033[0m"
    else:
        _c0 = _c1 = ""
    import numpy as np
    import torch

    from ..models import load_model
    from ..runtime import ContextParams, make_context

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}[args.dtype]

    t0 = time.time()
    from ..models.download import model_path_from_args

    args.model = model_path_from_args(args)
    model = load_model(args.model, dtype=dtype, device=args.device)
    from .args import apply_model_arg_overrides

    apply_model_arg_overrides(model, args)
    if args.verbose:
        print(f"[load] {args.model} in {time.time()-t0:.1f}s "
              f"arch={model.arch} n_layer={model.hparams.n_layer}", file=sys.stderr)

    ctx = make_context(model, ContextParams(n_ctx=args.ctx_size, dtype=dtype))
    vocab = model.vocab

    prompt = args.prompt
    if args.file:
        with open(args.file, encoding="utf-8") as f:
            prompt = f.read()
    system_prompt = args.system_prompt
    if args.system_prompt_file:
        with open(args.system_prompt_file, encoding="utf-8") as f:
            system_prompt = f.read()
    if args.escape and not args.no_escape:
        prompt = _unescape(prompt)
        system_prompt = _unescape(system_prompt)
        args.in_prefix = _unescape(args.in_prefix)
        args.in_suffix = _unescape(args.in_suffix)
    if system_prompt:
        prompt = system_prompt + ("\n" + prompt if prompt else "")

    from .args import sampler_from_args

    sampler = sampler_from_args(args, vocab=model.vocab,
                                n_vocab=model.hparams.n_vocab)

    spec = None
    if args.model_draft:
        from ..runtime.speculative import Speculative, SpeculativeParams

        # common_speculative_are_compatible analog: the draft must be an
        # attention model (the port loads the llama family alone and
        # refuses any other arch by name) with a near-identical vocab
        draft = load_model(args.model_draft, dtype=dtype, device=args.device)
        if abs(draft.hparams.n_vocab - model.hparams.n_vocab) > 100:
            print(f"error: draft vocab size {draft.hparams.n_vocab} is "
                  f"incompatible with target {model.hparams.n_vocab}",
                  file=sys.stderr)
            return 1
        spec = Speculative(
            draft, SpeculativeParams(n_draft=args.draft_max, p_min=args.draft_p_min),
            n_ctx=args.ctx_size)
        if args.verbose:
            print(f"[draft] {args.model_draft} arch={draft.arch}", file=sys.stderr)

    render_special = bool(getattr(args, "special", False))
    rev_prompts = list(getattr(args, "reverse_prompt", None) or [])

    def generate_round(text: str, n_predict: int, wrap: bool = False):
        if wrap:  # interactive user turns get the in-prefix/suffix wrap
            if args.in_prefix_bos:
                text = vocab.token_to_piece(vocab.bos_id, special=True) + text
            text = args.in_prefix + text + args.in_suffix
        toks = vocab.tokenize(text, add_special=int(ctx.n_past[0]) == 0)
        if args.verbose_prompt:
            for t in toks:
                print(f"{t:6d} -> {vocab.token_to_piece(t, special=True)!r}",
                      file=sys.stderr)
        if not args.no_display_prompt:
            sys.stdout.write(text)
            sys.stdout.flush()
        n = n_predict if n_predict >= 0 else args.ctx_size
        if spec is not None:
            from ..runtime.speculative import generate_speculative

            out, stats = generate_speculative(ctx, spec, toks, n_predict=n,
                                              sampler=sampler)
            for tok in out:
                if vocab.is_eog(tok):
                    break
                sys.stdout.write(_c0 + vocab.token_to_piece(tok, special=False) + _c1)
            sys.stdout.write("\n")
            if args.verbose:
                print(f"[spec] drafted={stats.get('n_drafted')} "
                      f"accepted={stats.get('n_accepted')}", file=sys.stderr)
            return
        if sampler is None and not args.interactive:
            # greedy: on-device bursts (one host read per chunk)
            out = ctx.generate(toks, n_predict=n, burst=int(args.burst))
            for tok in out:
                if vocab.is_eog(tok):
                    break
                sys.stdout.write(_c0 + vocab.token_to_piece(tok, special=False) + _c1)
            sys.stdout.write("\n")
            sys.stdout.flush()
            return
        logits = ctx.decode(np.asarray(toks, np.int32), n_logits=1)[-1]
        tail = ""
        for _ in range(n):
            if sampler is None:
                tok = int(np.argmax(logits))
            else:
                tok = sampler.sample(logits)
            if vocab.is_eog(tok) and not args.ignore_eos:
                break
            piece = vocab.token_to_piece(tok, special=render_special)
            sys.stdout.write(_c0 + piece + _c1 if _c0 else piece)
            sys.stdout.flush()
            if rev_prompts:
                tail = (tail + piece)[-64:]
                if any(r in tail for r in rev_prompts):
                    break
            logits = ctx.decode(np.asarray([tok], np.int32), n_logits=1)[-1]
        sys.stdout.write("\n")

    from ..runtime.profiling import maybe_profile

    interactive = (args.interactive or args.interactive_first
                   or (args.conversation and not args.no_conversation))
    if args.interactive_first and not prompt:
        prompt = ""
    restored = False
    if args.prompt_cache and os.path.exists(args.prompt_cache):
        from ..runtime.state import state_load

        try:
            state_load(ctx, args.prompt_cache)
            restored = True
            if args.verbose:
                print(f"[cache] restored {args.prompt_cache}", file=sys.stderr)
        except Exception as e:
            print(f"warning: prompt cache restore failed: {e}",
                  file=sys.stderr)

    with maybe_profile():  # TPULLAMA_PROFILE=<dir> writes a torch.profiler trace
        if interactive:
            print("== interactive mode (empty line to exit) ==", file=sys.stderr)
            if prompt and not args.interactive_first:
                generate_round(prompt, args.n_predict)
            while True:
                try:
                    line = input("> ")
                    if args.multiline_input:
                        while line.endswith("\\"):
                            line = line[:-1] + "\n" + input("  ")
                except EOFError:
                    break
                if not line:
                    break
                generate_round(line, args.n_predict, wrap=True)
                if args.single_turn:
                    break
        else:
            generate_round(prompt, args.n_predict)

    if args.prompt_cache and not args.prompt_cache_ro and not restored:
        from ..runtime.state import state_save

        state_save(ctx, args.prompt_cache)
        if args.verbose:
            print(f"[cache] saved {args.prompt_cache}", file=sys.stderr)

    if args.verbose:
        p = ctx.perf
        print(
            f"[perf] prefill {p.n_prefill} tok @ {p.prefill_tps():.1f} t/s | "
            f"decode {p.n_decode} tok @ {p.decode_tps():.1f} t/s",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
