"""Models: the dense decoder-only LM and its building blocks."""
