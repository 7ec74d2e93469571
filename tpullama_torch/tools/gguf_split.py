"""gguf-split tool: split a GGUF into shards / merge shards back (a copy of
tpullama/tools/gguf_split.py).

Reference analog: tools/gguf-split (naming '-%05d-of-%05d.gguf',
split.no/split.count/split.tensors.count KVs, llama.h:1350-1355).
The first shard carries the full KV metadata; continuation shards carry
only the split bookkeeping — exactly the layout the reference's loader
(and our model loader) expects.

Usage:
  python -m tpullama_torch.tools.gguf_split --split --split-max-tensors 128 in.gguf out_prefix
  python -m tpullama_torch.tools.gguf_split --merge in-00001-of-00003.gguf out.gguf
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np

from ..gguf import GGUFReader, GGUFWriter

SHARD_FMT = "{prefix}-{no:05d}-of-{count:05d}.gguf"


def split_gguf(src, out_prefix: str, max_tensors: int = 128) -> list[str]:
    r = GGUFReader(src)
    names = list(r.tensors)
    shards = [names[i : i + max_tensors] for i in range(0, len(names), max_tensors)]
    n = len(shards)
    paths = []
    for i, shard_names in enumerate(shards):
        w = GGUFWriter(alignment=r.alignment)
        if i == 0:
            for k, v in r.kv.items():
                if k.startswith("split."):
                    continue
                w.add_kv(k, v)
        w.add_u32("split.no", i)
        w.add_u32("split.count", n)
        w.add_i32("split.tensors.count", len(r.tensors))
        for name in shard_names:
            info = r.tensors[name]
            w.add_tensor(name, np.empty(info.shape), ggml_type=info.ggml_type,
                         raw=np.asarray(r.tensor_raw(name)))
        path = SHARD_FMT.format(prefix=out_prefix, no=i + 1, count=n)
        w.write(path)
        paths.append(path)
    return paths


def shard_paths_from_first(first_path: str) -> list[str]:
    m = re.match(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$", first_path)
    if not m:
        raise ValueError(f"not a shard filename: {first_path!r}")
    prefix, _, count = m.group(1), int(m.group(2)), int(m.group(3))
    return [SHARD_FMT.format(prefix=prefix, no=i + 1, count=count) for i in range(count)]


def merge_gguf(first_shard: str, dst) -> int:
    paths = shard_paths_from_first(first_shard)
    readers = [GGUFReader(p) for p in paths]
    w = GGUFWriter(alignment=readers[0].alignment)
    for k, v in readers[0].kv.items():
        if k.startswith("split."):
            continue
        w.add_kv(k, v)
    n = 0
    for r in readers:
        for name, info in r.tensors.items():
            w.add_tensor(name, np.empty(info.shape), ggml_type=info.ggml_type,
                         raw=np.asarray(r.tensor_raw(name)))
            n += 1
    w.write(dst)
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpullama-gguf-split", description=__doc__)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--split", action="store_true")
    mode.add_argument("--merge", action="store_true")
    ap.add_argument("--split-max-tensors", type=int, default=128)
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    if args.split:
        paths = split_gguf(args.input, args.output, args.split_max_tensors)
        print("\n".join(paths))
    else:
        n = merge_gguf(args.input, args.output)
        print(f"merged {n} tensors -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
