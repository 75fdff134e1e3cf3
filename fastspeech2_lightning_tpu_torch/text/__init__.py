from .processor import HARDCODED_INITIAL_SYMBOLS, PAD_SYMBOL, TextProcessor

__all__ = ["TextProcessor", "PAD_SYMBOL", "HARDCODED_INITIAL_SYMBOLS"]
