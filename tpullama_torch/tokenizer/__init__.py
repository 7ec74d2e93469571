"""Tokenizer layer: vocab loading + SPM/BPE/WPM tokenizer families (a copy
of tpullama/tokenizer)."""

from .vocab import TokenAttr, Vocab, VocabType

__all__ = ["Vocab", "VocabType", "TokenAttr"]
