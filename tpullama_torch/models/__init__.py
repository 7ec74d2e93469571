"""Model layer: hparams, the llama forward pass, the GGUF loader."""

from .hparams import HParams
from .loader import LoadedModel, QuantMeta, load_model, params_from_numpy

__all__ = ["HParams", "LoadedModel", "QuantMeta", "load_model", "params_from_numpy"]
