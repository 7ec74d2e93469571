"""Compute ops: plain PyTorch ops (norms, activations, rope, attention),
the planar weight repack, and the CUDA kernel wrappers in ops.cuda."""
