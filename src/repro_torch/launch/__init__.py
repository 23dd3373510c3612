"""Entry points of the port (``repro/launch`` at the same path)."""
