"""The HTTP synthesis server."""

from .server import SynthesisServer, serve

__all__ = ["SynthesisServer", "serve"]
