"""GGUF format layer: parser, writer and the block codecs the port needs
(a copy of tpullama/gguf; the port imports nothing of the JAX package)."""

from .constants import GGML_TYPE_TRAITS, GGMLType, GGUFValueType, Keys, row_nbytes
from .quants import dequantize, quantize
from .reader import GGUFReader, TensorInfo
from .writer import GGUFWriter

__all__ = [
    "GGMLType",
    "GGUFValueType",
    "GGML_TYPE_TRAITS",
    "Keys",
    "row_nbytes",
    "dequantize",
    "quantize",
    "GGUFReader",
    "TensorInfo",
    "GGUFWriter",
]
