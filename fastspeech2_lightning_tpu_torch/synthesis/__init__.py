"""Text encoding, chunking and the resident Synthesizer."""
