from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer, CheckpointIntegrityError)
