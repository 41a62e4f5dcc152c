"""ResNet (NHWC) with BatchNorm state — BASELINE config #1's model.

Port of ``apex_tpu/models/resnet.py`` (the model of
``examples/imagenet_amp.py``, apex's ResNet-50 ImageNet example):
``ResNetConfig`` (depths 26, 50, 101 and 152), ``init`` (the JAX tree,
names and shapes: conv weights HWIO, BatchNorm ``scale``/``bias`` in the
params and ``mean``/``var`` in a separate state tree), ``features``,
``forward``, ``loss`` and ``make_train_step`` over
:func:`~apex_tpu_torch.models.training.make_loss_train_step` with the
BatchNorm statistics riding ``TrainState.extra``.

Layout: activations are NHWC at every public function, as in JAX. Each
convolution views them as an NCHW tensor in channels-last memory (a
permutation, no copy) and its HWIO weight as a channels-last OIHW one, so
``F.conv2d`` runs in the tensor cores' NHWC layout and returns
channels-last. The JAX package computes convolutions, BatchNorm and
pooling in XLA, outside any Pallas kernel; here they are PyTorch ops.

XLA's ``"SAME"`` padding is asymmetric where the stride is 2: the 7x7
stem on 224 pads 2 before and 3 after, a 3x3 stride-2 convolution on an
even size 0 before and 1 after. ``F.conv2d(padding=k // 2)`` would pad
both sides alike and give other numbers, so :func:`_conv` pads
explicitly wherever the two sides differ. The max pool pads (1, 1) with
-inf, which is ``F.max_pool2d``'s own padding.

Only local BatchNorm (``bn_axis=None``, apex DDP without
``convert_syncbn_model``): a ``bn_axis`` raises (the distributed slice).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch import _tree
from apex_tpu_torch._capabilities import resolve_device
from apex_tpu_torch.data import normalize_images
from apex_tpu_torch.models import training as _training
from apex_tpu_torch.parallel.sync_batchnorm import sync_batch_norm

#: depth 26 = one bottleneck per stage — the smallest member of the
#: family, which the CPU oracles use
_STAGES = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
           152: (3, 8, 36, 3)}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """Every field of the JAX ``ResNetConfig`` with its default
    (ResNet-50, bf16 compute); ``compute_dtype`` is a torch dtype."""

    depth: int = 50
    num_classes: int = 1000
    width: int = 64
    #: mesh axis for cross-replica BatchNorm statistics; None = local
    bn_axis: Optional[str] = None
    compute_dtype: Any = torch.bfloat16
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5

    def __post_init__(self):
        if self.bn_axis is not None:
            raise ValueError(
                f"bn_axis={self.bn_axis!r} (SyncBatchNorm) is not supported "
                "by apex_tpu_torch yet (the distributed slice)")

    @property
    def stages(self):
        if self.depth not in _STAGES:
            raise ValueError(f"unsupported depth {self.depth}")
        return _STAGES[self.depth]

    def param_count(self) -> int:
        """Trainable parameters (conv weights, BN affines, the fc)."""
        n = 7 * 7 * 3 * self.width + 2 * self.width
        cin = self.width
        for si, n_blocks in enumerate(self.stages):
            planes = (64, 128, 256, 512)[si]
            for b in range(n_blocks):
                cout = planes * 4
                n += (cin * planes + 9 * planes * planes + planes * cout
                      + 2 * (2 * planes + cout))
                if (b == 0 and si > 0) or cin != cout:
                    n += cin * cout + 2 * cout
                cin = cout
        return n + cin * self.num_classes + self.num_classes


def init(cfg: ResNetConfig, generator: torch.Generator, *,
         device: Optional[Union[str, torch.device]] = None
         ) -> Tuple[Any, Any]:
    """``(params, bn_state)`` — the JAX ``init``'s trees: He-normal conv
    weights ``[kh, kw, cin, cout]`` (std ``sqrt(2 / fan_in)``), unit BN
    scales and zero biases, running means 0 and variances 1, the fc
    ``kernel [cin, classes]`` normal(0, 0.01) and a zero bias, all fp32.
    Draws come from ``generator``, which must live on ``device`` (None →
    CUDA)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(
            f"generator on {generator.device} but device is {dev}")

    def normal(shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        return t.normal_(0.0, std, generator=generator)

    def conv(kh, kw, cin, cout):
        return normal((kh, kw, cin, cout), (2.0 / (kh * kw * cin)) ** 0.5)

    def bn(c):
        f32 = dict(dtype=torch.float32, device=dev)
        return ({"scale": torch.ones(c, **f32), "bias": torch.zeros(c, **f32)},
                {"mean": torch.zeros(c, **f32), "var": torch.ones(c, **f32)})

    p: Any = {"stem": conv(7, 7, 3, cfg.width)}
    s: Any = {}
    p["bn_stem"], s["bn_stem"] = bn(cfg.width)
    cin = cfg.width
    for si, (n_blocks, planes) in enumerate(
            zip(cfg.stages, (64, 128, 256, 512))):
        blocks_p, blocks_s = [], []
        for b in range(n_blocks):
            stride = 2 if (b == 0 and si > 0) else 1
            cout = planes * 4
            bp, bs = {}, {}
            bp["conv1"] = conv(1, 1, cin, planes)
            bp["bn1"], bs["bn1"] = bn(planes)
            bp["conv2"] = conv(3, 3, planes, planes)
            bp["bn2"], bs["bn2"] = bn(planes)
            bp["conv3"] = conv(1, 1, planes, cout)
            bp["bn3"], bs["bn3"] = bn(cout)
            if stride != 1 or cin != cout:
                bp["downsample"] = conv(1, 1, cin, cout)
                bp["bn_ds"], bs["bn_ds"] = bn(cout)
            blocks_p.append(bp)
            blocks_s.append(bs)
            cin = cout
        p[f"layer{si + 1}"] = blocks_p
        s[f"layer{si + 1}"] = blocks_s
    p["fc"] = {"kernel": normal((cin, cfg.num_classes), 0.01),
               "bias": torch.zeros(cfg.num_classes, dtype=torch.float32,
                                   device=dev)}
    return p, s


def params_from_numpy(tree, *, device: Optional[Union[str, torch.device]]
                      = None) -> Any:
    """The JAX ``init``'s params (or any tree of numpy arrays) → the
    port's, on ``device`` (None → CUDA). The port keeps the JAX layouts
    (HWIO conv weights), so a flat optimizer buffer packs the same
    offsets on both sides; each convolution views its weight as
    channels-last OIHW."""
    dev = resolve_device(device)
    return _tree.tree_map(lambda a: _training._to_tensor(a, dev), tree)


#: the BatchNorm state crosses like the params
state_from_numpy = params_from_numpy


def params_to_numpy(tree) -> Any:
    """The reverse of :func:`params_from_numpy` (bf16 comes back as
    fp32); also the BatchNorm state's."""
    return _tree.tree_map(_training._to_numpy, tree)


state_to_numpy = params_to_numpy


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"``: output ``ceil(n / stride)``, the padding split
    with the smaller half before."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """``x [N, H, W, C]`` * HWIO ``w`` with ``"SAME"`` padding → NHWC."""
    kh, kw = w.shape[0], w.shape[1]
    (pt, pb), (pl, pr) = (_same_pads(x.shape[1], kh, stride),
                          _same_pads(x.shape[2], kw, stride))
    pad = (pt, pl)
    if (pt, pl) != (pb, pr):
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        pad = (0, 0)
    wn = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), wn, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def _bn(cfg: ResNetConfig, x, p, st, training: bool):
    y, rm, rv = sync_batch_norm(
        x, p["scale"], p["bias"], st["mean"], st["var"], axis=cfg.bn_axis,
        momentum=cfg.bn_momentum, eps=cfg.bn_eps, training=training,
        channel_axis=-1)
    return y, ({"mean": rm, "var": rv} if training else st)


def _bottleneck(cfg, x, p, st, stride: int, training: bool):
    ns = {}
    y = _conv(x, p["conv1"])
    y, ns["bn1"] = _bn(cfg, y, p["bn1"], st["bn1"], training)
    y = F.relu(y)
    y = _conv(y, p["conv2"], stride)
    y, ns["bn2"] = _bn(cfg, y, p["bn2"], st["bn2"], training)
    y = F.relu(y)
    y = _conv(y, p["conv3"])
    y, ns["bn3"] = _bn(cfg, y, p["bn3"], st["bn3"], training)
    if "downsample" in p:
        sc = _conv(x, p["downsample"], stride)
        sc, ns["bn_ds"] = _bn(cfg, sc, p["bn_ds"], st["bn_ds"], training)
    else:
        sc = x
    return F.relu(y + sc), ns


def features(cfg: ResNetConfig, params, state, x, *, training: bool = True):
    """``x [N, H, W, 3]`` → (stage feature maps ``{"c2".."c5"}``, NHWC in
    compute dtype, new BN state); with ``training=False`` the running
    statistics are used and returned unchanged."""
    x = x.to(cfg.compute_dtype)
    ns: Any = {}
    feats: Any = {}
    y = _conv(x, params["stem"], 2)
    y, ns["bn_stem"] = _bn(cfg, y, params["bn_stem"], state["bn_stem"],
                           training)
    y = F.relu(y)
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, padding=1).permute(
        0, 2, 3, 1).contiguous()
    for si, n_blocks in enumerate(cfg.stages):
        layer_p = params[f"layer{si + 1}"]
        layer_s = state[f"layer{si + 1}"]
        new_blocks = []
        for b in range(n_blocks):
            stride = 2 if (b == 0 and si > 0) else 1
            y, bs = _bottleneck(cfg, y, layer_p[b], layer_s[b], stride,
                                training)
            new_blocks.append(bs)
        ns[f"layer{si + 1}"] = new_blocks
        feats[f"c{si + 2}"] = y
    return feats, ns


def forward(cfg: ResNetConfig, params, state, x, *, training: bool = True):
    """``x [N, H, W, 3]`` → (logits ``[N, classes]`` fp32, new BN
    state)."""
    feats, ns = features(cfg, params, state, x, training=training)
    y = feats[f"c{len(cfg.stages) + 1}"]
    y = y.float().mean(dim=(1, 2))
    return y @ params["fc"]["kernel"] + params["fc"]["bias"], ns


def loss(cfg: ResNetConfig, params, state, images, labels, *,
         training: bool = True):
    """Mean softmax cross entropy → ``(loss, new BN state)``."""
    logits, ns = forward(cfg, params, state, images, training=training)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    return nll.mean(), ns


def make_train_step(cfg: ResNetConfig, optimizer, scaler_cfg=None, *,
                    clip_grad_norm: Optional[float] = None,
                    device: Optional[Union[str, torch.device]] = None):
    """``(init_fn, step_fn)`` for classification training on one device:
    ``init_fn(generator)`` builds params, optimizer state, scaler and the
    BN state (``TrainState.extra``) on ``device`` (None → CUDA);
    ``step_fn(state, images, labels) -> (state, metrics)``. uint8 image
    batches are dequantised and normalised on the device
    (:func:`~apex_tpu_torch.data.normalize_images`)."""
    dev = resolve_device(device)

    def loss_fn(p, bn_state, images, labels):
        if images.dtype == torch.uint8:
            images = normalize_images(images, torch.float32)
        return loss(cfg, p, bn_state, images, labels)

    return _training.make_loss_train_step(
        loss_fn, optimizer, init_params=lambda g: init(cfg, g, device=dev),
        scaler_cfg=scaler_cfg, clip_grad_norm=clip_grad_norm,
        init_extra="with_params", n_batch_args=2, device=dev)


__all__ = ["ResNetConfig", "features", "forward", "init", "loss",
           "make_train_step", "params_from_numpy", "params_to_numpy",
           "state_from_numpy", "state_to_numpy"]
