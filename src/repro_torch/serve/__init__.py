"""Serving steps of the port (``repro/serve`` at the same path)."""
from repro_torch.serve.serve_step import (  # noqa: F401
    flatten,
    make_decode_step,
    make_prefill_step,
    tasked_decode_loop,
)
