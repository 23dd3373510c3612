"""Training of the port (``repro/train`` at the same path): AdamW with
float32 master weights, the over-decomposed train step, and cross-pod
gradient compression."""
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,  # noqa: F401
                                         TrainState, adamw_update,
                                         global_norm, init_opt_state,
                                         lr_schedule)
from repro_torch.train.train_step import (TrainConfig,  # noqa: F401
                                          abstract_train_state,
                                          init_train_state, make_grad_fn,
                                          make_loss_fn, make_mesh_grad_fn,
                                          make_train_step,
                                          runtime_allreduce)
