"""GGUF format layer: parser, writer, the block codecs and the memory and
split-future sources (a copy of tpullama/gguf; the port imports nothing of
the JAX package)."""

from .constants import GGML_TYPE_TRAITS, GGMLType, GGUFValueType, Keys, row_nbytes
from .quants import dequantize, quantize
from .reader import GGUFReader, TensorInfo
from .stream import (
    BufferSource,
    SplitFutureRegistry,
    fulfill_split_future,
)
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
    "BufferSource",
    "SplitFutureRegistry",
    "fulfill_split_future",
]
