"""Declarative CLI flag system — the common/arg.cpp analog.

Each flag is declared once with its aliases, type, default, scope set,
and LLAMA_ARG_* environment mirror (same names as the reference,
common/arg.cpp:76-105,808+: the env var supplies the default; an
explicit CLI flag always wins). Tools request a parser scoped to their
example name the way the reference scopes common_arg entries.

Only flags whose capability exists in this framework are declared; the
parser also accepts tool-local extras added on top.
"""

from __future__ import annotations

import argparse
import sys
import os
from dataclasses import dataclass, field


@dataclass
class Flag:
    flags: tuple  # ("-m", "--model")
    dest: str | None = None
    type: object = str
    default: object = None
    env: str | None = None  # LLAMA_ARG_* mirror
    help: str = ""
    scopes: tuple = ("cli", "server", "perplexity", "bench", "embedding",
                     "mtmd", "tokenize", "imatrix")
    action: str | None = None  # "store_true" for bool switches
    nargs: object = None
    metavar: object = None
    choices: tuple | None = None
    required: bool = False
    # flags the reference exposes whose mechanism dissolves on this
    # backend (threads/offload/NUMA/...) parse for compatibility and
    # warn with the reason when explicitly set
    noop: str | None = None


def _b(v: str) -> bool:
    return str(v).lower() not in ("", "0", "false", "off", "no")


def _warn_action(base, reason, flagname):
    class _Warn(base):
        def __call__(self, parser, ns, values, option_string=None):
            import sys

            print(f"warning: {flagname} has no effect on this backend "
                  f"({reason})", file=sys.stderr)
            super().__call__(parser, ns, values, option_string)

    return _Warn


ALL = "cli server perplexity bench embedding mtmd tokenize imatrix".split()
SRV = ("server",)
GEN = ("cli", "server", "mtmd")

FLAGS = [
    # model / load
    Flag(("-m", "--model"), env="LLAMA_ARG_MODEL", help="model GGUF path"),
    Flag(("-hf", "-hfr", "--hf-repo"), dest="hf_repo", default="",
         env="LLAMA_ARG_HF_REPO",
         help="<user>/<model>[:quant] resolved against the local model "
              "cache (env LLAMA_CACHE; offline-only in this build)"),
    Flag(("-hff", "--hf-file"), dest="hf_file", default="",
         env="LLAMA_ARG_HF_FILE"),
    Flag(("-hfd", "-hfrd", "--hf-repo-draft"), dest="hf_repo_draft",
         default="", scopes=GEN, env="LLAMA_ARG_HFD_REPO"),
    Flag(("-hft", "--hf-token"), dest="hf_token", default="",
         env="HF_TOKEN", noop="cache-only resolution needs no auth token"),
    Flag(("-md", "--model-draft"), env="LLAMA_ARG_MODEL_DRAFT",
         scopes=GEN, help="draft model for speculative decoding"),
    Flag(("--mmproj",), env="LLAMA_ARG_MMPROJ", scopes=("cli", "server", "mtmd"),
         help="multimodal projector GGUF"),
    Flag(("--lora",), dest="lora", action="append",
         help="LoRA adapter GGUF (repeatable; FILE[:scale])"),
    Flag(("--control-vector",), dest="control_vector", action="append",
         scopes=GEN, help="control vector GGUF (FILE[:strength])"),
    Flag(("--check-tensors",), action="store_true",
         help="validate tensor data while loading"),
    # context
    Flag(("-c", "--ctx-size"), type=int, default=4096, env="LLAMA_ARG_CTX_SIZE",
         help="context size per sequence"),
    Flag(("-b", "--batch-size"), type=int, default=2048, env="LLAMA_ARG_BATCH",
         help="logical batch size"),
    Flag(("-ub", "--ubatch-size"), type=int, default=512, env="LLAMA_ARG_UBATCH",
         help="physical micro-batch size"),
    Flag(("-np", "--parallel"), type=int, default=1, env="LLAMA_ARG_N_PARALLEL",
         scopes=("server", "bench"), help="number of parallel sequences"),
    Flag(("-ctk", "--cache-type-k"), default="f16",
         env="LLAMA_ARG_CACHE_TYPE_K", choices=("f16", "bf16", "f32", "q8_0"),
         help="KV cache K dtype (q8_0 = int8 cache)"),
    Flag(("-ctv", "--cache-type-v"), default="f16",
         env="LLAMA_ARG_CACHE_TYPE_V", choices=("f16", "bf16", "f32", "q8_0"),
         help="KV cache V dtype"),
    Flag(("--swa-full",), action="store_true", env="LLAMA_ARG_SWA_FULL",
         help="full-size KV cache for SWA layers (disables the iswa "
              "window-sized ring cache)"),
    Flag(("--no-context-shift",), action="store_true",
         env="LLAMA_ARG_NO_CONTEXT_SHIFT", scopes=GEN,
         help="disable automatic context shift"),
    Flag(("--keep",), type=int, default=0, scopes=GEN,
         help="tokens to keep on context shift"),
    Flag(("--grp-attn-n",), type=int, default=1, env="LLAMA_ARG_GRP_ATTN_N",
         scopes=("cli",), help="self-extend group factor"),
    Flag(("--grp-attn-w",), type=int, default=512, env="LLAMA_ARG_GRP_ATTN_W",
         scopes=("cli",), help="self-extend window"),
    # rope overrides
    Flag(("--rope-freq-base",), type=float, default=0.0,
         env="LLAMA_ARG_ROPE_FREQ_BASE", help="rope base override (0 = model)"),
    Flag(("--rope-freq-scale",), type=float, default=0.0,
         env="LLAMA_ARG_ROPE_FREQ_SCALE", help="rope scale override"),
    Flag(("--rope-scaling",), default="", env="LLAMA_ARG_ROPE_SCALING_TYPE",
         choices=("", "none", "linear", "yarn"), help="rope scaling type"),
    Flag(("--yarn-orig-ctx",), type=int, default=0, env="LLAMA_ARG_YARN_ORIG_CTX",
         help="YaRN original context length"),
    # generation
    Flag(("-n", "--n-predict"), type=int, default=-1, env="LLAMA_ARG_N_PREDICT",
         scopes=GEN, help="max tokens to generate (-1 = until EOG)"),
    Flag(("-p", "--prompt"), default="", scopes=("cli", "mtmd", "bench")),
    Flag(("-f", "--file"), scopes=("cli", "perplexity", "imatrix", "tokenize"),
         help="read input text from file"),
    Flag(("-s", "--seed"), type=int, default=-1, scopes=GEN),
    Flag(("--temp",), type=float, default=0.8, scopes=GEN),
    Flag(("--top-k",), type=int, default=40, scopes=GEN),
    Flag(("--top-p",), type=float, default=0.95, scopes=GEN),
    Flag(("--min-p",), type=float, default=0.05, scopes=GEN),
    Flag(("--typical",), dest="typical_p", type=float, default=1.0, scopes=GEN),
    Flag(("--xtc-probability",), type=float, default=0.0, scopes=GEN),
    Flag(("--xtc-threshold",), type=float, default=0.1, scopes=GEN),
    Flag(("--top-n-sigma", "--top-nsigma"), type=float, default=-1.0,
         scopes=GEN),
    Flag(("--repeat-penalty",), type=float, default=1.0, scopes=GEN),
    Flag(("--repeat-last-n",), type=int, default=64, scopes=GEN),
    Flag(("--presence-penalty",), type=float, default=0.0, scopes=GEN),
    Flag(("--frequency-penalty",), type=float, default=0.0, scopes=GEN),
    Flag(("--dry-multiplier",), type=float, default=0.0, scopes=GEN),
    Flag(("--dry-base",), type=float, default=1.75, scopes=GEN),
    Flag(("--dry-allowed-length",), type=int, default=2, scopes=GEN),
    Flag(("--mirostat",), type=int, default=0, scopes=GEN),
    Flag(("--mirostat-lr",), dest="mirostat_eta", type=float, default=0.1,
         scopes=GEN),
    Flag(("--mirostat-ent",), dest="mirostat_tau", type=float, default=5.0,
         scopes=GEN),
    Flag(("--grammar",), default="", scopes=GEN, help="GBNF grammar string"),
    Flag(("--grammar-file",), default="", scopes=GEN),
    Flag(("-j", "--json-schema"), default="", scopes=GEN,
         help="JSON schema for constrained output"),
    Flag(("--ignore-eos",), action="store_true", scopes=GEN),
    # speculative decoding
    Flag(("--draft-max", "--draft"), type=int, default=16,
         env="LLAMA_ARG_DRAFT_MAX", scopes=GEN),
    Flag(("--draft-min",), type=int, default=0, env="LLAMA_ARG_DRAFT_MIN",
         scopes=GEN),
    Flag(("--draft-p-min",), type=float, default=0.75,
         env="LLAMA_ARG_DRAFT_P_MIN", scopes=GEN),
    # server
    Flag(("--host",), default="127.0.0.1", env="LLAMA_ARG_HOST", scopes=SRV),
    Flag(("--port",), type=int, default=8080, env="LLAMA_ARG_PORT", scopes=SRV),
    Flag(("--api-key",), default="", env="LLAMA_API_KEY", scopes=SRV),
    Flag(("-a", "--alias"), default="", env="LLAMA_ARG_ALIAS", scopes=SRV,
         help="model name served via the API"),
    Flag(("--chat-template",), default="", env="LLAMA_ARG_CHAT_TEMPLATE",
         scopes=SRV),
    Flag(("--chat-template-file",), default="",
         env="LLAMA_ARG_CHAT_TEMPLATE_FILE", scopes=SRV),
    Flag(("--jinja",), action="store_true", env="LLAMA_ARG_JINJA", scopes=SRV),
    Flag(("--embeddings",), action="store_true", env="LLAMA_ARG_EMBEDDINGS",
         scopes=SRV),
    Flag(("--reranking",), action="store_true", env="LLAMA_ARG_RERANKING",
         scopes=SRV),
    Flag(("--pooling",), default="", env="LLAMA_ARG_POOLING",
         choices=("", "none", "mean", "cls", "last", "rank"),
         scopes=("server", "embedding")),
    Flag(("--metrics",), action="store_true", env="LLAMA_ARG_ENDPOINT_METRICS",
         scopes=SRV, help="enable the Prometheus /metrics endpoint"),
    Flag(("--no-webui",), action="store_true", env="LLAMA_ARG_NO_WEBUI",
         scopes=SRV),
    Flag(("--models-dir",), default="", env="LLAMA_ARG_MODELS_DIR", scopes=SRV,
         help="router mode: directory of models servable via /models/load"),
    Flag(("--models-max",), type=int, default=4, env="LLAMA_ARG_MODELS_MAX",
         scopes=SRV, help="router mode: max resident child models"),
    Flag(("--slot-save-path",), default="", scopes=SRV),
    Flag(("--cache-reuse",), type=int, default=0, env="LLAMA_ARG_CACHE_REUSE",
         scopes=SRV, help="min chunk length for prompt-cache reuse"),
    # misc / runtime
    Flag(("--dtype",), default="bfloat16",
         choices=("float32", "bfloat16", "float16"),
         help="activation dtype"),
    Flag(("--device",), default=None, env="LLAMA_ARG_DEVICE",
         help="torch device: the CUDA card by default, cpu for the plain "
              "PyTorch path"),
    Flag(("-tp", "--tensor-split-shards"), dest="tp", type=int, default=1,
         help="tensor-parallel shard count (SPLIT_MODE_ROW analog)"),
    Flag(("-sm", "--split-mode"), default="none",
         choices=("none", "layer", "row"),
         env="LLAMA_ARG_SPLIT_MODE",
         help="multi-device split mode: row = tensor parallel, "
              "layer = pipeline stages"),
    Flag(("--no-perf",), action="store_true", env="LLAMA_ARG_NO_PERF"),
    Flag(("--verbose", "-v"), action="store_true"),
    # ---------------- round-4 arg audit tranche (common/arg.cpp parity;
    # every reference flag is classified in docs/ARGS_AUDIT.md) ----------
    # sampling tail
    Flag(("--dynatemp-range",), type=float, default=0.0, scopes=GEN,
         help="dynamic temperature range (0 = disabled)"),
    Flag(("--dynatemp-exp",), dest="dynatemp_exponent", type=float,
         default=1.0, scopes=GEN),
    Flag(("--dry-penalty-last-n",), type=int, default=-1, scopes=GEN),
    Flag(("--dry-sequence-breaker",), dest="dry_sequence_breakers",
         action="append", scopes=GEN,
         help="DRY breaker string (repeatable; 'none' clears defaults)"),
    Flag(("-l", "--logit-bias"), dest="logit_bias", action="append",
         scopes=GEN, help="TOKEN_ID(+/-)BIAS, e.g. 1234+3 or 432-inf"),
    Flag(("-jf", "--json-schema-file"), default="", scopes=GEN),
    Flag(("--samplers",), default="", scopes=GEN,
         help="semicolon list restricting + ordering the chain "
              "(penalties;dry;top_n_sigma;top_k;typ_p;top_p;min_p;xtc;"
              "temperature)"),
    Flag(("--sampling-seq", "--sampler-seq"), dest="sampling_seq", default="",
         scopes=GEN, help="single-char sampler order (edskypmxt)"),
    # prompt / conversation (cli)
    Flag(("-sys", "--system-prompt"), dest="system_prompt", default="",
         scopes=("cli",)),
    Flag(("-sysf", "--system-prompt-file"), dest="system_prompt_file",
         default="", scopes=("cli",)),
    Flag(("-e", "--escape"), action="store_true", scopes=("cli", "perplexity",
         "mtmd"), help="process prompt escape sequences (\n, \t, ...)"),
    Flag(("--no-escape",), action="store_true", scopes=("cli",)),
    Flag(("--in-prefix",), default="", scopes=("cli",),
         help="string prepended to user inputs"),
    Flag(("--in-suffix",), default="", scopes=("cli",),
         help="string appended after user inputs"),
    Flag(("--in-prefix-bos",), action="store_true", scopes=("cli",)),
    Flag(("-sp", "--special"), dest="special", action="store_true",
         scopes=("cli", "mtmd"), help="render special tokens in output"),
    Flag(("-cnv", "--conversation"), dest="conversation",
         action="store_true", scopes=("cli",)),
    Flag(("-no-cnv", "--no-conversation"), dest="no_conversation",
         action="store_true", scopes=("cli",)),
    Flag(("-st", "--single-turn"), dest="single_turn", action="store_true",
         scopes=("cli",)),
    Flag(("-if", "--interactive-first"), dest="interactive_first",
         action="store_true", scopes=("cli",)),
    Flag(("-mli", "--multiline-input"), dest="multiline_input",
         action="store_true", scopes=("cli",)),
    Flag(("--verbose-prompt",), action="store_true", scopes=("cli", "mtmd")),
    Flag(("-ptc", "--print-token-count"), dest="print_token_count", type=int,
         default=-1, scopes=("cli",)),
    Flag(("--no-warmup",), action="store_true",
         scopes=("cli", "server", "embedding", "mtmd"),
         help="skip the warmup decode after load"),
    Flag(("-r", "--reverse-prompt"), dest="reverse_prompt", action="append",
         scopes=("cli",)),
    Flag(("--prompt-cache",), default="", scopes=("cli",),
         help="session state file: restored if present, saved after run"),
    Flag(("--prompt-cache-all",), action="store_true", scopes=("cli",)),
    Flag(("--prompt-cache-ro",), action="store_true", scopes=("cli",)),
    # rope / yarn load-time overrides
    Flag(("--rope-scale",), type=float, default=0.0, scopes=ALL,
         env="LLAMA_ARG_ROPE_SCALE",
         help="rope context scaling factor"),
    Flag(("--yarn-ext-factor",), type=float, default=-1.0, scopes=ALL,
         env="LLAMA_ARG_YARN_EXT_FACTOR"),
    Flag(("--yarn-attn-factor",), type=float, default=1.0, scopes=ALL,
         env="LLAMA_ARG_YARN_ATTN_FACTOR"),
    Flag(("--yarn-beta-slow",), type=float, default=1.0, scopes=ALL,
         env="LLAMA_ARG_YARN_BETA_SLOW"),
    Flag(("--yarn-beta-fast",), type=float, default=32.0, scopes=ALL,
         env="LLAMA_ARG_YARN_BETA_FAST"),
    Flag(("--override-kv",), dest="override_kv", action="append", scopes=ALL,
         help="override model metadata KEY=TYPE:VALUE (int/float/bool/str)"),
    # perplexity / evals
    Flag(("--kl-divergence",), action="store_true", scopes=("perplexity",)),
    Flag(("--ppl-stride",), type=int, default=0, scopes=("perplexity",)),
    Flag(("--ppl-output-type",), type=int, default=0, scopes=("perplexity",)),
    Flag(("--chunks",), type=int, default=-1,
         scopes=("perplexity", "imatrix"), help="max chunks to process"),
    # embedding tool
    Flag(("--embd-normalize",), type=int, default=2, scopes=("embedding",),
         help="-1=none 0=max-abs-int16 1=taxicab 2=euclidean >2=p-norm"),
    Flag(("--embd-output-format",), default="", scopes=("embedding",),
         choices=("", "array", "json", "json+"),),
    Flag(("--embd-separator",), default="\n", scopes=("embedding",)),
    Flag(("--cls-separator",), default="\t", scopes=("embedding",)),
    # imatrix tool
    Flag(("-o", "--output", "--output-file"), dest="output_file", default="",
         scopes=("imatrix", "perplexity", "embedding")),
    Flag(("-ofreq", "--output-frequency"), dest="output_frequency", type=int,
         default=10, scopes=("imatrix",)),
    Flag(("--save-frequency",), type=int, default=0, scopes=("imatrix",)),
    Flag(("--process-output",), action="store_true", scopes=("imatrix",)),
    Flag(("--no-ppl",), action="store_true", scopes=("imatrix",)),
    Flag(("--chunk", "--from-chunk"), dest="from_chunk", type=int, default=0,
         scopes=("imatrix",)),
    Flag(("--show-statistics",), action="store_true", scopes=("imatrix",)),
    Flag(("--parse-special",), action="store_true",
         scopes=("imatrix", "perplexity")),
    # batched-bench dims
    Flag(("-npp",), dest="npp", default="", scopes=("bench",),
         help="prompt lengths (comma list)"),
    Flag(("-ntg",), dest="ntg", default="", scopes=("bench",),
         help="gen lengths (comma list)"),
    Flag(("-npl",), dest="npl", default="", scopes=("bench",),
         help="parallel seq counts (comma list)"),
    Flag(("-pps",), action="store_true", scopes=("bench",),
         help="prompt is shared across parallel sequences"),
    # server tail
    Flag(("--path",), dest="static_path", default="", scopes=SRV,
         env="LLAMA_ARG_STATIC_PATH", help="static files dir for the webui"),
    Flag(("--api-prefix",), default="", scopes=SRV,
         env="LLAMA_ARG_API_PREFIX"),
    Flag(("--api-key-file",), default="", scopes=SRV),
    Flag(("-to", "--timeout"), dest="timeout", type=int, default=600,
         scopes=SRV, env="LLAMA_ARG_TIMEOUT"),
    Flag(("--threads-http",), type=int, default=-1, scopes=SRV,
         env="LLAMA_ARG_THREADS_HTTP",
         noop="the server uses a thread-per-connection model"),
    Flag(("--props",), action="store_true", scopes=SRV,
         env="LLAMA_ARG_ENDPOINT_PROPS",
         help="enable POST /props settings changes"),
    Flag(("--slots",), action="store_true", scopes=SRV,
         env="LLAMA_ARG_ENDPOINT_SLOTS"),
    Flag(("--no-slots",), action="store_true", scopes=SRV,
         env="LLAMA_ARG_NO_ENDPOINT_SLOTS"),
    Flag(("--no-jinja",), action="store_true", scopes=SRV),
    Flag(("--reasoning-format",), default="auto", scopes=SRV,
         choices=("auto", "none", "deepseek", "deepseek-legacy"),
         env="LLAMA_ARG_THINK"),
    Flag(("--reasoning-budget",), type=int, default=-1, scopes=SRV,
         env="LLAMA_ARG_THINK_BUDGET"),
    Flag(("--no-prefill-assistant",), action="store_true", scopes=SRV,
         env="LLAMA_ARG_NO_PREFILL_ASSISTANT"),
    Flag(("-sps", "--slot-prompt-similarity"), dest="slot_prompt_similarity",
         type=float, default=0.1, scopes=SRV),
    Flag(("--chat-template-kwargs",), default="", scopes=SRV,
         env="LLAMA_CHAT_TEMPLATE_KWARGS",
         help="JSON dict of extra chat-template variables"),
    Flag(("--media-path",), default="", scopes=SRV,
         help="directory for local media references in /v1 requests"),
    Flag(("--no-models-autoload",), action="store_true", scopes=SRV,
         env="LLAMA_ARG_NO_MODELS_AUTOLOAD"),
    Flag(("--ssl-key-file",), default="", scopes=SRV,
         env="LLAMA_ARG_SSL_KEY_FILE"),
    Flag(("--ssl-cert-file",), default="", scopes=SRV,
         env="LLAMA_ARG_SSL_CERT_FILE"),
    # logging
    Flag(("--log-disable",), action="store_true"),
    Flag(("--log-file",), default=""),
    Flag(("--log-colors",), default="auto", choices=("auto", "on", "off"),
         env="LLAMA_LOG_COLORS"),
    Flag(("--log-prefix",), action="store_true", env="LLAMA_LOG_PREFIX"),
    Flag(("--log-timestamps",), action="store_true",
         env="LLAMA_LOG_TIMESTAMPS"),
    Flag(("-lv", "--verbosity", "--log-verbosity"), dest="log_verbosity",
         type=int, default=0, env="LLAMA_LOG_VERBOSITY"),
    Flag(("--offline",), action="store_true", env="LLAMA_OFFLINE",
         noop="this environment performs no network fetches"),
    # draft-model tail
    Flag(("-cd", "--ctx-size-draft"), dest="ctx_size_draft", type=int,
         default=0, scopes=GEN, env="LLAMA_ARG_CTX_SIZE_DRAFT"),
    Flag(("--draft-p-split",), type=float, default=0.1, scopes=GEN,
         env="LLAMA_ARG_DRAFT_P_SPLIT"),
    Flag(("--spec-replace",), action="append", scopes=GEN,
         help="TARGET:DRAFT template-token translation pair"),
    Flag(("-ctkd", "--cache-type-k-draft"), dest="cache_type_k_draft",
         default="", scopes=GEN, env="LLAMA_ARG_CACHE_TYPE_K_DRAFT"),
    Flag(("-ctvd", "--cache-type-v-draft"), dest="cache_type_v_draft",
         default="", scopes=GEN, env="LLAMA_ARG_CACHE_TYPE_V_DRAFT"),
    # tts
    Flag(("-mv", "--model-vocoder"), dest="model_vocoder", default="",
         scopes=("cli",)),
    Flag(("--tts-speaker-file",), default="", scopes=("cli",)),
    Flag(("--tts-use-guide-tokens",), action="store_true", scopes=("cli",)),
    # cvector
    Flag(("--positive-file",), default="", scopes=("cli",)),
    Flag(("--negative-file",), default="", scopes=("cli",)),
    Flag(("--pca-batch",), type=int, default=100, scopes=("cli",)),
    Flag(("--pca-iter",), type=int, default=1000, scopes=("cli",)),
    Flag(("--method",), default="pca", choices=("pca", "mean"),
         scopes=("cli",)),
    # host-runtime flags that dissolve on this backend (PyTorch owns
    # threading/placement; no CPU<->card offload split exists)
    Flag(("-t", "--threads"), dest="threads", type=int, default=-1,
         env="LLAMA_ARG_THREADS",
         noop="PyTorch owns host threading"),
    Flag(("-tb", "--threads-batch"), dest="threads_batch", type=int,
         default=-1, noop="PyTorch owns host threading"),
    Flag(("--cpu-strict",), type=int, default=0,
         noop="PyTorch owns host threading"),
    Flag(("--prio",), type=int, default=0, noop="PyTorch owns host threading"),
    Flag(("--poll",), type=int, default=50, noop="PyTorch owns host threading"),
    Flag(("-fa", "--flash-attn"), dest="flash_attn", default="auto",
         scopes=ALL, env="LLAMA_ARG_FLASH_ATTN",
         noop="the hand-written flash attention kernels are always on"),
    Flag(("-ngl", "--gpu-layers", "--n-gpu-layers"), dest="n_gpu_layers",
         type=int, default=-1, env="LLAMA_ARG_N_GPU_LAYERS",
         noop="no host/card layer split: every layer runs on the card"),
    Flag(("-ts", "--tensor-split"), dest="tensor_split", default="",
         noop="one card: the multi-card split modes are not ported yet"),
    Flag(("-mg", "--main-gpu"), dest="main_gpu", type=int, default=0,
         noop="the card is chosen by --device (cuda:N)"),
    Flag(("--mlock",), action="store_true", env="LLAMA_ARG_MLOCK",
         noop="weights live in the card's memory, not pageable host memory"),
    Flag(("--no-mmap",), action="store_true", env="LLAMA_ARG_NO_MMAP",
         noop="the loader always reads through mmap onto the card"),
    Flag(("--numa",), default="", noop="PyTorch owns host memory placement"),
    Flag(("-nkvo", "--no-kv-offload"), dest="no_kv_offload",
         action="store_true", env="LLAMA_ARG_NO_KV_OFFLOAD",
         noop="the KV cache always lives on the card"),
    Flag(("-nr", "--no-repack"), dest="no_repack", action="store_true",
         noop="packed weights are repacked into the planes the qmm kernels read"),
    Flag(("--no-op-offload",), action="store_true",
         noop="no host/card op split exists"),
    Flag(("--override-tensor", "-ot"), dest="override_tensor",
         action="append",
         noop="no per-tensor buffer placement: one card memory"),
    Flag(("--cpu-moe", "-cmoe"), dest="cpu_moe", action="store_true",
         env="LLAMA_ARG_CPU_MOE",
         noop="no host/card expert split: every expert lives on the card"),
    Flag(("--n-cpu-moe", "-ncmoe"), dest="n_cpu_moe", type=int, default=0,
         env="LLAMA_ARG_N_CPU_MOE",
         noop="no host/card expert split: every expert lives on the card"),
    Flag(("--rpc",), default="", noop="one process on one card: no RPC "
         "backend"),
    Flag(("--list-devices",), action="store_true",
         help="print available accelerator devices and exit"),
    # ---- round-5 full common/arg.cpp audit: every remaining reference
    # flag gets a row here — wired where the capability exists, noop=
    # with the reason where the mechanism dissolves on this backend.
    Flag(("-cl", "--cache-list"), action="cache_list",
         help="list cached models (models.download cache) and exit"),
    Flag(("--no-display-prompt",), action="store_true", scopes=("cli", "mtmd"),
         help="don't echo the prompt before generation"),
    Flag(("-co", "--color"), action="store_true", scopes=("cli",),
         help="colorize generated output"),
    Flag(("--context-shift",), action="store_true", scopes=GEN,
         env="LLAMA_ARG_CONTEXT_SHIFT",
         help="enable automatic context shift (pairs --no-context-shift)"),
    Flag(("--spm-infill",), action="store_true", scopes=SRV,
         help="suffix-prefix-middle infill token order"),
    Flag(("-lcs", "--lookup-cache-static"), default="", scopes=("cli",),
         help="static n-gram cache for lookup decoding"),
    Flag(("-lcd", "--lookup-cache-dynamic"), default="", scopes=("cli",),
         help="dynamic n-gram cache path (updated + saved)"),
    Flag(("--control-vector-scaled",), action="append", nargs=2,
         metavar=("FILE", "SCALE"), scopes=GEN,
         help="control vector with a custom strength (repeatable)"),
    Flag(("--control-vector-layer-range",), nargs=2, type=int,
         metavar=("START", "END"), scopes=GEN, default=None,
         help="apply control vectors only to layers [START, END]"),
    Flag(("-hfv", "-hfrv", "--hf-repo-v"), dest="hf_repo_v", default="",
         env="LLAMA_ARG_HF_REPO_V", scopes=("cli",),
         help="vocoder model -hf spec (tts)"),
    Flag(("-hffv", "--hf-file-v"), dest="hf_file_v", default="",
         env="LLAMA_ARG_HF_FILE_V", scopes=("cli",)),
    Flag(("-ns", "--sequences"), dest="sequences", type=int, default=1,
         scopes=("perplexity", "bench"),
         noop="parallel sequence count is driven by -np/--parallel here"),
    Flag(("-cb", "--cont-batching"), action="store_true", scopes=SRV,
         env="LLAMA_ARG_CONT_BATCHING",
         noop="continuous batching is structural in this engine (always on)"),
    Flag(("-nocb", "--no-cont-batching"), action="store_true", scopes=SRV,
         env="LLAMA_ARG_NO_CONT_BATCHING",
         noop="continuous batching cannot be disabled on this engine"),
    Flag(("-dt", "--defrag-thold"), type=float, default=0.1,
         env="LLAMA_ARG_DEFRAG_THOLD",
         noop="the bitset cell pool + scatter writes never fragment"),
    Flag(("--ctx-checkpoints", "--swa-checkpoints"), type=int, default=8,
         env="LLAMA_ARG_CTX_CHECKPOINTS", scopes=SRV,
         noop="full per-slot KV stays device-resident; SWA rollback "
              "recompute checkpoints are not needed"),
    Flag(("--cache-ram", "-cram"), type=int, default=-1,
         env="LLAMA_ARG_CACHE_RAM", scopes=SRV,
         noop="no host-RAM KV offload tier on this backend"),
    Flag(("--no-host",), action="store_true", env="LLAMA_ARG_NO_HOST",
         noop="no host-pinned weight buffers on this backend"),
    Flag(("--attention",), default="", choices=("", "causal", "non-causal"),
         scopes=("embedding", "server"),
         noop="attention causality follows the model arch (encoders run "
              "non-causal)"),
    Flag(("--image-min-tokens",), type=int, default=-1,
         scopes=("mtmd", "server"), env="LLAMA_ARG_IMAGE_MIN_TOKENS",
         noop="image token budget is fixed by each projector family's "
              "preprocessing spec"),
    Flag(("--image-max-tokens",), type=int, default=-1,
         scopes=("mtmd", "server"), env="LLAMA_ARG_IMAGE_MAX_TOKENS",
         noop="image token budget is fixed by each projector family's "
              "preprocessing spec"),
    Flag(("--no-mmproj",), action="store_true", scopes=("cli", "server", "mtmd"),
         env="LLAMA_ARG_NO_MMPROJ",
         noop="mmproj is only loaded when --mmproj is passed explicitly"),
    Flag(("--no-mmproj-offload",), action="store_true",
         scopes=("cli", "server", "mtmd"), env="LLAMA_ARG_NO_MMPROJ_OFFLOAD",
         noop="single-backend execution; nothing to offload"),
    Flag(("--mmproj-backend",), default="", scopes=("cli", "server", "mtmd"),
         noop="single-backend execution"),
    Flag(("--mmproj-url",), default="", scopes=("cli", "server", "mtmd"),
         env="LLAMA_ARG_MMPROJ_URL",
         noop="this environment performs no network fetches"),
    Flag(("-mu", "--model-url"), default="", env="LLAMA_ARG_MODEL_URL",
         noop="this environment performs no network fetches"),
    Flag(("-dr", "--docker-repo"), default="",
         noop="this environment performs no network fetches"),
    Flag(("--simple-io",), action="store_true", scopes=("cli",),
         noop="plain stdio is already the only console mode"),
    # retrieval / passkey / parallel example flags: those demos are not
    # shipped; the capabilities they demonstrate (embeddings, long
    # context, parallel decoding) are covered by the server + tests
    Flag(("--context-file",), action="append",
         noop="retrieval demo not shipped; /v1/embeddings covers it"),
    Flag(("--chunk-size",), type=int, default=64,
         noop="retrieval demo not shipped"),
    Flag(("--chunk-separator",), default="\n",
         noop="retrieval demo not shipped"),
    Flag(("--junk",), type=int, default=250,
         noop="passkey demo not shipped; long-context covered by tests"),
    Flag(("--pos",), type=int, default=-1,
         noop="passkey demo not shipped"),
    # CPU affinity / polling / priority family: PyTorch owns host
    # threading — same disposition as -t/--threads
    Flag(("-C", "--cpu-mask"), default="", noop="PyTorch owns host threading"),
    Flag(("-Cr", "--cpu-range"), default="", noop="PyTorch owns host threading"),
    Flag(("-Cb", "--cpu-mask-batch"), default="",
         noop="PyTorch owns host threading"),
    Flag(("-Crb", "--cpu-range-batch"), default="",
         noop="PyTorch owns host threading"),
    Flag(("--cpu-strict-batch",), type=int, default=0,
         noop="PyTorch owns host threading"),
    Flag(("--prio-batch",), type=int, default=0,
         noop="PyTorch owns host threading"),
    Flag(("--poll-batch",), type=int, default=50,
         noop="PyTorch owns host threading"),
    Flag(("-td", "--threads-draft"), type=int, default=-1, scopes=GEN,
         noop="PyTorch owns host threading"),
    Flag(("-tbd", "--threads-batch-draft"), type=int, default=-1, scopes=GEN,
         noop="PyTorch owns host threading"),
    Flag(("-Cd", "--cpu-mask-draft"), default="", scopes=GEN,
         noop="PyTorch owns host threading"),
    Flag(("-Crd", "--cpu-range-draft"), default="", scopes=GEN,
         noop="PyTorch owns host threading"),
    Flag(("--cpu-strict-draft",), type=int, default=0, scopes=GEN,
         noop="PyTorch owns host threading"),
    Flag(("--prio-draft",), type=int, default=0, scopes=GEN,
         noop="PyTorch owns host threading"),
    Flag(("--poll-draft",), type=int, default=50, scopes=GEN,
         noop="PyTorch owns host threading"),
    Flag(("-Cbd", "--cpu-mask-batch-draft"), default="", scopes=GEN,
         noop="PyTorch owns host threading"),
    Flag(("-Crbd", "--cpu-range-batch-draft"), default="", scopes=GEN,
         noop="PyTorch owns host threading"),
    Flag(("--cpu-strict-batch-draft",), type=int, default=0, scopes=GEN,
         noop="PyTorch owns host threading"),
    Flag(("--prio-batch-draft",), type=int, default=0, scopes=GEN,
         noop="PyTorch owns host threading"),
    Flag(("--poll-batch-draft",), type=int, default=50, scopes=GEN,
         noop="PyTorch owns host threading"),
    Flag(("-devd", "--device-draft"), default="", scopes=GEN,
         noop="the draft model runs on the same card"),
    Flag(("-ngld", "--gpu-layers-draft", "--n-gpu-layers-draft"),
         type=int, default=-1, scopes=GEN, env="LLAMA_ARG_N_GPU_LAYERS_DRAFT",
         noop="all layers always run on device (no CPU offload tier)"),
    Flag(("--override-tensor-draft", "-otd"), action="append", scopes=GEN,
         noop="no per-tensor host/device placement on this backend"),
    Flag(("--cpu-moe-draft", "-cmoed"), action="store_true", scopes=GEN,
         env="LLAMA_ARG_CPU_MOE_DRAFT",
         noop="no CPU offload tier for expert tensors"),
    Flag(("--n-cpu-moe-draft", "-ncmoed"), type=int, default=0, scopes=GEN,
         env="LLAMA_ARG_N_CPU_MOE_DRAFT",
         noop="no CPU offload tier for expert tensors"),
    # training (tools/finetune.py drives runtime/train.py with these)
    Flag(("-lr", "--learning-rate"), dest="learning_rate", type=float,
         default=1e-4, scopes=("finetune",)),
    Flag(("-lr-min", "--learning-rate-min"), dest="learning_rate_min",
         type=float, default=0.0, scopes=("finetune",)),
    Flag(("-decay-epochs", "--learning-rate-decay-epochs"),
         dest="decay_epochs", type=float, default=-1, scopes=("finetune",)),
    Flag(("-wd", "--weight-decay"), dest="weight_decay", type=float,
         default=0.0, scopes=("finetune",)),
    Flag(("-val-split", "--val-split"), dest="val_split", type=float,
         default=0.05, scopes=("finetune",)),
    Flag(("-epochs", "--epochs"), dest="epochs", type=int, default=2,
         scopes=("finetune",)),
    Flag(("-opt", "--optimizer"), dest="optimizer", default="adamw",
         choices=("adamw", "sgd"), scopes=("finetune",)),
    Flag(("--lora-init-without-apply",), action="store_true",
         scopes=("finetune",),
         help="initialize LoRA weights without merging into the base"),
]

# -hf model-preset shortcuts (arg.cpp:3000+ *-default/-spec entries):
# each pre-fills hf_repo (and the draft repo for the -spec pairs); the
# cache-only resolver then maps them to local files
HF_PRESETS = {
    "--tts-oute-default": ("OuteAI/OuteTTS-0.2-500M-GGUF:Q8_0", ""),
    "--embd-gemma-default": ("ggml-org/embeddinggemma-300M-qat-q4_0-GGUF", ""),
    "--fim-qwen-1.5b-default": ("ggml-org/Qwen2.5-Coder-1.5B-Q8_0-GGUF", ""),
    "--fim-qwen-3b-default": ("ggml-org/Qwen2.5-Coder-3B-Q8_0-GGUF", ""),
    "--fim-qwen-7b-default": ("ggml-org/Qwen2.5-Coder-7B-Q8_0-GGUF", ""),
    "--fim-qwen-7b-spec": ("ggml-org/Qwen2.5-Coder-7B-Q8_0-GGUF",
                           "ggml-org/Qwen2.5-Coder-0.5B-Q8_0-GGUF"),
    "--fim-qwen-14b-spec": ("ggml-org/Qwen2.5-Coder-14B-Q8_0-GGUF",
                            "ggml-org/Qwen2.5-Coder-0.5B-Q8_0-GGUF"),
    "--fim-qwen-30b-default": ("ggml-org/Qwen3-Coder-30B-A3B-Instruct-Q8_0-GGUF", ""),
    "--gpt-oss-20b-default": ("ggml-org/gpt-oss-20b-GGUF", ""),
    "--gpt-oss-120b-default": ("ggml-org/gpt-oss-120b-GGUF", ""),
    "--vision-gemma-4b-default": ("ggml-org/gemma-3-4b-it-qat-GGUF", ""),
    "--vision-gemma-12b-default": ("ggml-org/gemma-3-12b-it-qat-GGUF", ""),
}


class _PresetAction(argparse.Action):
    """arg.cpp *-default/-spec shortcuts: pre-fill hf_repo (+ draft)."""

    def __call__(self, parser, ns, values, option_string=None):
        repo, draft = HF_PRESETS[option_string]
        ns.hf_repo = repo
        if draft and hasattr(ns, "hf_repo_draft"):
            ns.hf_repo_draft = draft


class _CacheListAction(argparse.Action):
    def __call__(self, parser, ns, values, option_string=None):
        from ..models.download import cache_dir, list_cached_models

        ents = list_cached_models()
        print(f"cache dir: {cache_dir()}")
        for e in ents:
            print(f"  {e['name']}  {e['size'] / 2**20:.1f} MiB")
        if not ents:
            print("  (empty)")
        parser.exit(0)


class _CompletionBashAction(argparse.Action):
    def __call__(self, parser, ns, values, option_string=None):
        opts = " ".join(
            s for a in parser._actions for s in a.option_strings)
        prog = parser.prog
        fn = "_" + prog.replace("-", "_")
        print(f"""{fn}() {{
  local cur=${{COMP_WORDS[COMP_CWORD]}}
  COMPREPLY=( $(compgen -W "{opts}" -- "$cur") )
}}
complete -F {fn} {prog}""")
        parser.exit(0)


def build_parser(scope: str, prog: str, description: str = "",
                 model_required: bool = True) -> argparse.ArgumentParser:
    """Parser with every flag whose scope set includes `scope`; env
    mirrors provide defaults (explicit CLI args override)."""
    ap = argparse.ArgumentParser(prog=prog, description=description)
    for fl in FLAGS:
        if scope not in fl.scopes:
            continue
        kw: dict = {"help": fl.help or None, "dest": fl.dest}
        envval = os.environ.get(fl.env) if fl.env else None
        if fl.action == "cache_list":
            kw.update(action=_CacheListAction, nargs=0)
        elif fl.action == "append":
            kw.update(action="append", default=[])
        elif fl.action == "store_true":
            act = "store_true" if fl.noop is None else _warn_action(
                argparse._StoreTrueAction, fl.noop, fl.flags[-1])
            kw.update(action=act,
                      default=_b(envval) if envval is not None else False)
        else:
            default = envval if envval is not None else fl.default
            if default is not None and fl.type is not str:
                default = fl.type(default)
            kw.update(type=fl.type, default=default)
            if fl.noop is not None:
                kw["action"] = _warn_action(argparse._StoreAction, fl.noop,
                                            fl.flags[-1])
            if fl.choices:
                kw["choices"] = list(fl.choices)
        if fl.nargs is not None:
            kw["nargs"] = fl.nargs
            kw.pop("type", None) if fl.type is str else None
        if fl.metavar is not None:
            kw["metavar"] = fl.metavar
        if kw["dest"] is None:
            del kw["dest"]
        ap.add_argument(*fl.flags, **kw)
    if scope in ("cli", "server", "mtmd", "bench", "perplexity"):
        # --version / -cl / --completion-bash: informational exits
        from .. import __version__

        ap.add_argument("--version", action="version",
                        version=f"tpullama {__version__}")
        ap.add_argument("--completion-bash", action=_CompletionBashAction,
                        nargs=0, help="print a bash completion script")
        # -hf model-preset shortcuts
        for opt in HF_PRESETS:
            ap.add_argument(opt, action=_PresetAction, nargs=0,
                            help=argparse.SUPPRESS)
    if model_required and scope != "server":
        # match the reference: -m is required unless the env mirror set
        # it — or unless -hf provides a resolvable spec (arg.cpp:220
        # pre-fills the model path from hf_repo), checked post-parse by
        # models.download.model_path_from_args
        argv_probe = sys.argv[1:]
        if not any(a.startswith(("-hf", "--hf-repo")) for a in argv_probe) \
                and not os.environ.get("LLAMA_ARG_HF_REPO"):
            for a in ap._actions:
                if a.dest == "model" and a.default is None:
                    a.required = True
    return ap


def kv_dtype_from_arg(name: str):
    """--cache-type-k/-v as a torch dtype (q8_0: int8, the quantized KV
    cache of ContextParams(kv_dtype=torch.int8))."""
    import torch

    return {"f16": torch.float16, "bf16": torch.bfloat16, "f32": torch.float32,
            "q8_0": torch.int8}[name]


# sampler-name registry for --samplers / --sampling-seq (the reference's
# common_sampler_type_from_str / _from_chr tables, common/sampling.cpp)
_SAMPLER_NAMES = ("penalties", "dry", "top_n_sigma", "top_k", "typ_p",
                  "top_p", "min_p", "xtc", "temperature")
_SAMPLER_CHARS = {"e": "penalties", "d": "dry", "s": "top_n_sigma",
                  "k": "top_k", "y": "typ_p", "p": "top_p", "m": "min_p",
                  "x": "xtc", "t": "temperature"}


def parse_logit_bias(items):
    """TOKEN_ID(+|-)BIAS entries (common/arg.cpp --logit-bias), incl.
    the -inf ban form."""
    out = {}
    for it in items or ():
        it = it.replace(":", "+") if ":" in it and "+" not in it else it
        import re as _re

        m = _re.match(r"^(\d+)\s*([+-])\s*(inf|[0-9.]+)$", it.strip())
        if not m:
            raise ValueError(f"invalid logit bias {it!r}")
        tok = int(m.group(1))
        val = float("inf") if m.group(3) == "inf" else float(m.group(3))
        out[tok] = -val if m.group(2) == "-" else val
    return out


def sampler_order_from_args(args):
    """Resolve --samplers / --sampling-seq to an ordered name list (None =
    default chain)."""
    seq = getattr(args, "sampling_seq", "") or ""
    if seq:
        return [_SAMPLER_CHARS[c] for c in seq if c in _SAMPLER_CHARS]
    names = getattr(args, "samplers", "") or ""
    if names:
        return [n for n in names.replace(",", ";").split(";")
                if n in _SAMPLER_NAMES]
    return None


def sampler_from_args(args, vocab=None, n_vocab: int = 0):
    """Full SamplerChain from the registered sampling flags (the
    common_params_sampling -> common_sampler_init path)."""
    from ..runtime.sampling import SamplerChain

    breakers = getattr(args, "dry_sequence_breakers", None)
    if breakers == ["none"]:
        breakers = []
    schema = getattr(args, "json_schema", "") or ""
    jf = getattr(args, "json_schema_file", "") or ""
    if jf:
        schema = open(jf, encoding="utf-8").read()
    g_text = getattr(args, "grammar", "") or ""
    gf = getattr(args, "grammar_file", "") or ""
    if gf:
        g_text = open(gf, encoding="utf-8").read()
    if schema and not g_text:
        from ..runtime.json_schema import json_schema_to_gbnf

        g_text = json_schema_to_gbnf(schema)
    if args.temp <= 0 and not getattr(args, "mirostat", 0):
        # greedy selection still applies logit bias / penalties / grammar
        # first (common_sampler keeps the full chain and only the final
        # selection becomes argmax); the bare-argmax fast path is taken
        # only when no modifier is active
        lb = parse_logit_bias(getattr(args, "logit_bias", None))
        penalties_active = (
            args.repeat_penalty != 1.0
            or getattr(args, "frequency_penalty", 0.0) != 0.0
            or getattr(args, "presence_penalty", 0.0) != 0.0
        )
        dry_active = getattr(args, "dry_multiplier", 0.0) > 0
        if not (lb or penalties_active or dry_active or g_text):
            return None  # pure argmax
    chain = SamplerChain.from_params(
        vocab=vocab,
        seed=args.seed if args.seed >= 0 else 0xFFFFFFFF,
        temp=args.temp,
        dynatemp_range=getattr(args, "dynatemp_range", 0.0),
        dynatemp_exponent=getattr(args, "dynatemp_exponent", 1.0),
        top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
        typical_p=getattr(args, "typical_p", 1.0),
        xtc_probability=getattr(args, "xtc_probability", 0.0),
        xtc_threshold=getattr(args, "xtc_threshold", 0.1),
        top_n_sigma=getattr(args, "top_n_sigma", -1.0),
        penalty_last_n=args.repeat_last_n,
        penalty_repeat=args.repeat_penalty,
        penalty_freq=getattr(args, "frequency_penalty", 0.0),
        penalty_present=getattr(args, "presence_penalty", 0.0),
        dry_multiplier=getattr(args, "dry_multiplier", 0.0),
        dry_base=getattr(args, "dry_base", 1.75),
        dry_allowed_length=getattr(args, "dry_allowed_length", 2),
        dry_penalty_last_n=getattr(args, "dry_penalty_last_n", -1),
        dry_sequence_breakers=breakers,
        mirostat=getattr(args, "mirostat", 0),
        mirostat_tau=getattr(args, "mirostat_tau", 5.0),
        mirostat_eta=getattr(args, "mirostat_eta", 0.1),
        logit_bias=parse_logit_bias(getattr(args, "logit_bias", None)),
        n_vocab=n_vocab,
    )
    if g_text:
        # --grammar / --grammar-file / --json-schema(-file): constrain
        # after the logit-shaping samplers (bias/penalties/dry) but
        # before truncation/selection, so top-k/top-p can never discard
        # every grammar-valid token (common_sampler grammar slot)
        from ..runtime.grammar import Grammar, GrammarSampler

        shaping = {"logit-bias", "logit_bias", "penalties", "dry"}
        pos = 0
        for i, sm in enumerate(chain.samplers):
            if getattr(sm, "name", "") in shaping:
                pos = i + 1
        chain.samplers.insert(
            pos, GrammarSampler(Grammar.from_gbnf(g_text, vocab=vocab)))
    order = sampler_order_from_args(args)
    if order is not None:
        keep = set(order)
        alias = {"penalties": ("penalties", "logit_bias"), "dry": ("dry",),
                 "top_n_sigma": ("top_n_sigma",), "top_k": ("top_k",),
                 "typ_p": ("typical",), "top_p": ("top_p",),
                 "min_p": ("min_p",), "xtc": ("xtc",),
                 "temperature": ("temp", "temp_ext")}
        allowed = {n for k in keep for n in alias.get(k, (k,))}
        allowed |= {"dist", "mirostat", "logit_bias", "grammar", "infill"}
        chain.samplers = [sm for sm in chain.samplers
                          if getattr(sm, "name", "") in allowed]
    return chain


def parse_override_kv(items):
    """--override-kv KEY=TYPE:VALUE (llama_model_kv_override analog)."""
    out = {}
    for it in items or ():
        key, _, tv = it.partition("=")
        typ, _, val = tv.partition(":")
        if typ == "int":
            out[key] = int(val)
        elif typ == "float":
            out[key] = float(val)
        elif typ == "bool":
            out[key] = _b(val)
        elif typ == "str":
            out[key] = val
        else:
            raise ValueError(f"--override-kv type must be int/float/bool/str: {it!r}")
    return out


def apply_model_arg_overrides(model, args):
    """Load-time hparam overrides: rope/yarn flags + --override-kv
    (llama_context_params rope fields + kv_overrides)."""
    hp = model.hparams
    rs = getattr(args, "rope_scaling", "") or ""
    if rs:
        hp.rope_scaling = rs
    if getattr(args, "rope_scale", 0.0):
        hp.rope_scaling = hp.rope_scaling if hp.rope_scaling != "none" else "linear"
        hp.rope_freq_scale = 1.0 / args.rope_scale
    if getattr(args, "rope_freq_base", 0.0):
        hp.rope_freq_base = args.rope_freq_base
    if getattr(args, "rope_freq_scale", 0.0):
        hp.rope_freq_scale = args.rope_freq_scale
    if getattr(args, "yarn_orig_ctx", 0):
        hp.n_ctx_orig_yarn = args.yarn_orig_ctx
    if getattr(args, "yarn_ext_factor", -1.0) >= 0:
        hp.rope_yarn_ext_factor = args.yarn_ext_factor
    if getattr(args, "yarn_attn_factor", 1.0) != 1.0:
        hp.rope_attn_factor = args.yarn_attn_factor
    if getattr(args, "yarn_beta_slow", 1.0) != 1.0:
        hp.rope_beta_slow = args.yarn_beta_slow
    if getattr(args, "yarn_beta_fast", 32.0) != 32.0:
        hp.rope_beta_fast = args.yarn_beta_fast
    for key, val in parse_override_kv(
            getattr(args, "override_kv", None)).items():
        # map gguf key tails onto hparam fields where known; unknown keys
        # attach verbatim for arch code that reads hp.extra
        tail = key.rsplit(".", 1)[-1]
        field_map = {
            "rope_freq_base": "rope_freq_base",
            "freq_base": "rope_freq_base",
            "sliding_window": "n_swa",
            "expert_used_count": "n_expert_used",
        }
        if tail in field_map:
            setattr(hp, field_map[tail], val)
        elif hasattr(hp, tail):
            setattr(hp, tail, val)
        else:
            if not hasattr(hp, "extra") or hp.extra is None:
                hp.extra = {}
            hp.extra[key] = val
    return model
