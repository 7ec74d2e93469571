"""Model resolution for `-hf <user>/<model>[:quant]` — the offline-shaped
analog of the reference's common_download_model / common_get_hf_file
(common/download.h, common/arg.cpp:220-260).

This environment performs no network fetches, so resolution is
cache-only: a repo spec resolves against a local cache directory using
the reference's on-disk naming (`<user>_<model>_<file>.gguf`, cache dir
from $LLAMA_CACHE like fs_get_cache_directory), plus a few lenient
fallbacks (any cached GGUF whose name contains the model and tag). A
miss raises FileNotFoundError with the cache contents listed — the same
contract an --offline run of the reference has when the cache is cold.

When network egress exists, `fetch` is the seam where an HTTP download
would slot in; it is deliberately separated from `resolve` so the
resolution logic stays testable offline.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass


def cache_dir() -> str:
    """fs_get_cache_directory analog: $LLAMA_CACHE, else
    $TPULLAMA_MODEL_CACHE, else ~/.cache/tpullama."""
    for env in ("LLAMA_CACHE", "TPULLAMA_MODEL_CACHE"):
        if os.environ.get(env):
            return os.environ[env]
    base = os.environ.get(
        "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "tpullama")


@dataclass
class HfSpec:
    user: str
    model: str
    tag: str  # quant tag after ':' ("" = unspecified -> any/latest)

    @property
    def repo(self) -> str:
        return f"{self.user}/{self.model}"


def parse_hf_spec(spec: str) -> HfSpec:
    """<user>/<model>[:quant] (arg.cpp -hf docstring)."""
    repo, _, tag = spec.partition(":")
    user, sep, model = repo.partition("/")
    if not sep or not user or not model:
        raise ValueError(
            f"invalid -hf spec {spec!r}: expected <user>/<model>[:quant]")
    return HfSpec(user, model, tag)


def list_cached_models(directory: str | None = None) -> list[dict]:
    """common_list_cached_models analog: enumerate cached GGUFs."""
    d = directory or cache_dir()
    out = []
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if name.endswith(".gguf"):
            p = os.path.join(d, name)
            out.append({"name": name, "path": p,
                        "size": os.path.getsize(p)})
    return out


def resolve(spec: str, hf_file: str = "",
            directory: str | None = None) -> str:
    """Resolve a -hf spec to a local cached GGUF path (no network).

    Order: exact reference cache name `<user>_<model>_<hf_file>` →
    any cached gguf containing both the model name and the quant tag →
    any cached gguf containing the model name (when no tag given).
    Raises FileNotFoundError listing the cache when nothing matches."""
    s = parse_hf_spec(spec)
    d = directory or cache_dir()
    cached = list_cached_models(d)

    if hf_file:
        exact = os.path.join(d, f"{s.user}_{s.model}_{hf_file}")
        if os.path.exists(exact):
            return exact
        if os.path.exists(os.path.join(d, hf_file)):
            return os.path.join(d, hf_file)

    def norm(t: str) -> str:
        return re.sub(r"[^a-z0-9]", "", t.lower())

    model_n = norm(s.model)
    tag_n = norm(s.tag)
    scored = []
    for ent in cached:
        n = norm(ent["name"])
        if model_n not in n:
            continue
        if tag_n and tag_n not in n:
            continue
        # prefer names that also carry the user
        scored.append((norm(s.user) in n, ent["path"]))
    if scored:
        scored.sort(reverse=True)
        return scored[0][1]

    have = ", ".join(e["name"] for e in cached) or "(empty)"
    raise FileNotFoundError(
        f"-hf {spec}: no cached GGUF matches in {d} (cache: {have}). "
        "This environment performs no network fetches; place the file in "
        "the cache directory (env LLAMA_CACHE) named "
        f"'{s.user}_{s.model}_<file>.gguf'.")


def model_path_from_args(args) -> str:
    """-m wins; otherwise -hf resolves from the local cache (the
    arg.cpp:220 pre-fill rule: -m may be omitted when -hf is given)."""
    if getattr(args, "model", ""):
        return args.model
    hf = getattr(args, "hf_repo", "") or ""
    if hf:
        return resolve(hf, getattr(args, "hf_file", "") or "")
    raise SystemExit("error: either -m/--model or -hf/--hf-repo is required")
