"""Hand-written Hopper (sm_90a) kernels of the port and their wrappers.

Each module holds one kernel's wrapper, its plain PyTorch version and a
launch counter: qmm (csrc/qmm.cu, csrc/qmm_ktiled.cu), qmm_gathered
(csrc/qmm_gathered.cu), flash_attention (csrc/flash_attention.cu),
flash_decode (csrc/flash_decode.cu), fused_layer (csrc/fused_layer.cu).
A wrapper launches its kernel for CUDA tensors or raises; it computes the
plain version only for CPU tensors.
build.library() compiles the sources on first use.
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
