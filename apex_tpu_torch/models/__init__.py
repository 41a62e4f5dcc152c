"""Models of the port: GPT (the serving slice of ``apex_tpu.models.gpt``)."""

from apex_tpu_torch.models import gpt
from apex_tpu_torch.models.gpt import GPTConfig

__all__ = ["GPTConfig", "gpt"]
