"""Hand-written Hopper (sm_90a) kernels of the port and their wrappers.

Each module holds one kernel's wrapper, its plain PyTorch version and a
launch counter: qmm (csrc/qmm.cu, csrc/qmm_ktiled.cu), qmm_gathered
(csrc/qmm_gathered.cu), flash_attention (csrc/flash_attention.cu),
flash_decode (csrc/flash_decode.cu), fused_layer (csrc/fused_layer.cu).
A wrapper launches its kernel for CUDA tensors or raises; it computes the
plain version only for CPU tensors.
build.library() compiles the sources on first use.

The counters are Python-side: a wrapper that runs while a CUDA graph is
captured counts a launch the card has not made. The Context that captures
a graph takes those counts out (add_launch_counts(counts, -1)) and adds
them back at each replay.
"""


def _counters() -> tuple:
    from . import flash_attention, flash_decode, fused_layer, qmm, qmm_gathered

    return (qmm.LAUNCHES, qmm_gathered.LAUNCHES, flash_attention.LAUNCHES,
            flash_decode.LAUNCHES, fused_layer.LAUNCHES)


def launch_counts() -> dict:
    """Launches of every kernel since the last reset_launch_counts()."""
    return {k: v for d in _counters() for k, v in d.items()}


def reset_launch_counts() -> None:
    for d in _counters():
        for k in d:
            d[k] = 0


def add_launch_counts(counts: dict, sign: int = 1) -> None:
    """Add `sign` times `counts` (kernel name -> launches) to the counters."""
    for d in _counters():
        for k in d:
            d[k] += sign * counts.get(k, 0)
