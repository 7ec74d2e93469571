#!/usr/bin/env python3
"""Save, or compare bit for bit, qmm_gemv's outputs on seeded inputs.

    python3 scripts/torch_gemv_outputs.py save ROOT OUT.pt
    python3 scripts/torch_gemv_outputs.py compare A.pt B.pt

`save` imports tpullama_torch from the checkout at ROOT (building its
kernels there at first use), runs quantized_matmul at T <= 8 (the
qmm_gemv route) on one CUDA card over the decode shapes of chip_smoke.py's
kernels phase, every T bucket, field set, x and scale dtype and both
stored orders, with inputs made from a fixed seed on the card, and saves
the outputs. `compare` checks two such files for equal bits, case by case,
so two checkouts' decode bodies can be held to the same arithmetic: save
from each in one call on one card, then compare. Exits non-zero on a
difference or without a card.
"""

from __future__ import annotations

import sys

Q4, Q6, Q8 = "Q4_K", "Q6_K", "Q8_0"
# (type, N, K, x dtype, scale dtype, order, T values)
CASES = [(Q4, 4096, 4096, "bf16", "bf16", "stripe", (1, 4)),
         (Q4, 1024, 4096, "bf16", "bf16", "stripe", (1, 4)),
         (Q4, 14336, 4096, "bf16", "bf16", "stripe", (1, 2, 3, 4, 5, 8)),
         (Q4, 4096, 14336, "bf16", "bf16", "stripe", (1, 4, 8)),
         (Q6, 128256, 4096, "bf16", "bf16", "stripe", (1, 4)),
         (Q4, 4096, 4096, "f32", "f32", "stripe", (1, 8)),
         (Q6, 4096, 4096, "f32", "f32", "stripe", (1, 8)),
         (Q8, 4096, 4096, "f32", "bf16", "stripe", (1, 8)),
         (Q4, 1536, 8960, "bf16", "bf16", "stripe", (1, 4)),
         (Q4, 1024, 768, "bf16", "bf16", "stripe", (1, 4)),
         (Q6, 1024, 768, "bf16", "bf16", "stripe", (1, 4)),
         (Q8, 3584, 3584, "bf16", "bf16", "stripe", (1, 4)),
         (Q8, 1024, 512, "f32", "bf16", "stripe", (1, 4)),
         (Q4, 4096, 4096, "bf16", "bf16", "fourblock", (1, 4)),
         (Q4, 27392, 4096, "bf16", "bf16", "fourblock", (1,))]


def planes(torch, qtype: str, N: int, K: int, sdt, gen, device) -> dict:
    """Uniform packed bytes and per-group scales (values of std ~0.02)."""
    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen, device=device)

    def scales(G, base):
        return (base * (0.8 + 0.4 * torch.rand((N, G), generator=gen, device=device))).to(sdt)

    if qtype == Q6:
        s = scales(K // 16, 1.1e-3)
        return {"q4": u8(N, K // 2), "q2": u8(N, K // 4), "scale": s, "minv": 32.0 * s}
    if qtype == Q8:
        return {"q8": u8(N, K), "scale": scales(K // 32, 2.7e-4)}
    s = scales(K // 32, 4.4e-3)
    return {"q4": u8(N, K // 2), "scale": s, "minv": 7.5 * s}


def save(root: str, out: str) -> int:
    sys.path.insert(0, root)
    import torch

    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.cuda import qmm

    if not torch.cuda.is_available():
        print("torch_gemv_outputs: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    outs = {}
    for qt, N, K, xdt, sdt, order, Ts in CASES:
        f = planes(torch, qt, N, K, dt[sdt], gen, device)
        for T in Ts:
            x = torch.randn((T, K), generator=gen, device=device).to(dt[xdt])
            before = qmm.LAUNCHES["qmm_gemv"]
            y = qmm.quantized_matmul(x, f, GGMLType[qt], 16 if qt == Q6 else 32, N, K,
                                     order=order)
            if qmm.LAUNCHES["qmm_gemv"] != before + 1:
                print(f"{qt} {N}x{K} T={T}: not the qmm_gemv route", file=sys.stderr)
                return 1
            outs[f"{qt} {N}x{K} x={xdt} s={sdt} {order} T={T}"] = y.cpu()
    torch.save(outs, out)
    print(f"saved {len(outs)} outputs of {root} to {out}")
    return 0


def compare(a: str, b: str) -> int:
    import torch

    ya, yb = torch.load(a), torch.load(b)
    if set(ya) != set(yb):
        print(f"the files hold other cases: {sorted(set(ya) ^ set(yb))}")
        return 1
    differ = [k for k in ya if not torch.equal(ya[k], yb[k])]
    for k in differ:
        print(f"differs: {k}: max |a - b| {float((ya[k] - yb[k]).abs().max())}")
    print(f"{len(ya) - len(differ)} of {len(ya)} outputs bit-identical")
    return 1 if differ else 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "save":
        sys.exit(save(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
