"""Models of the port: GPT (``apex_tpu.models.gpt``), BERT with its MLM
head (``apex_tpu.models.bert``) and the fused train steps
(``apex_tpu.models.training``)."""

from apex_tpu_torch.models import bert, gpt, training
from apex_tpu_torch.models.bert import BertConfig, make_mlm_train_step
from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.models.training import (
    TrainState,
    make_loss_train_step,
    make_train_step,
)

__all__ = ["BertConfig", "GPTConfig", "TrainState", "bert", "gpt",
           "make_loss_train_step", "make_mlm_train_step", "make_train_step",
           "training"]
