"""Models of the port: GPT (``apex_tpu.models.gpt``) and its fused train
step (``apex_tpu.models.training``)."""

from apex_tpu_torch.models import gpt, training
from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.models.training import TrainState, make_train_step

__all__ = ["GPTConfig", "TrainState", "gpt", "make_train_step", "training"]
