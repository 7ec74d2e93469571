"""Hand-written Hopper (sm_90a) kernels of the port and their wrappers.

Each module holds one kernel's wrapper, its plain PyTorch version and a
launch counter: qmm (csrc/qmm.cu), flash_attention
(csrc/flash_attention.cu), flash_decode (csrc/flash_decode.cu). A wrapper
launches its kernel for CUDA tensors or raises; it computes the plain
version only for CPU tensors. build.library() compiles the sources on
first use.
"""


def launch_counts() -> dict:
    """Launches of every kernel since the last reset_launch_counts()."""
    from . import flash_attention, flash_decode, qmm

    return {**qmm.LAUNCHES, **flash_attention.LAUNCHES, **flash_decode.LAUNCHES}


def reset_launch_counts() -> None:
    from . import flash_attention, flash_decode, qmm

    for d in (qmm.LAUNCHES, flash_attention.LAUNCHES, flash_decode.LAUNCHES):
        for k in d:
            d[k] = 0
