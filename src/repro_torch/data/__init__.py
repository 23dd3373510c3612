"""Data pipelines of the port (``repro/data`` at the same path)."""
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: F401
