"""The model stack of the port (``repro/models`` at the same path)."""
from repro_torch.models.model_zoo import Model, build_model, build_smoke  # noqa: F401
from repro_torch.models.transformer import DEFAULT_FLAGS, Flags, SMOKE_FLAGS  # noqa: F401
