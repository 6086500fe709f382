"""ResNet — BASELINE config 3 (ASHA on ResNet-50/CIFAR-10, one GPU per trial).

Port of ``metaopt_tpu/models/resnet.py``: the bottleneck-block ResNet with
the CIFAR stem (3×3, no max-pool), depth 50 by default; the ASHA fidelity
axis is ``epochs``. What the port keeps of flax's semantics, on every
device (the CPU included, so that CPU parity compares like with like):

- **dtypes**: convolutions take bf16 inputs and kernels and give bf16;
  batch norm (statistics and output), the residual add, the mean pool and
  the dense head run in f32; parameters are f32. Casts are explicit.
- **SAME padding**: a stride-2 3×3 conv on an even input pads (0, 1) per
  spatial axis, as flax does, not PyTorch's symmetric (1, 1).
- **batch norm**: ε 1e-5; flax's momentum (0.9 in the blocks, the default
  0.99 in the stem); the running variance is the biased batch variance,
  updated here in f32 without grad (``F.batch_norm`` would store the
  unbiased one).
- **initialization**: conv and dense kernels lecun-normal truncated to two
  standard deviations, the last batch-norm scale of each block zero,
  other scales one, biases zero.
- **the optimizer**: :class:`SGD`, optax's decayed weights + Nesterov SGD
  in ``torch._foreach`` ops.

Data is NHWC (``models/data.py``); the model permutes it to NCHW with
``channels_last`` strides, which copies nothing. :func:`params_from_flax`
loads a flax ``ResNet``'s ``params`` and ``batch_stats``.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metaopt_tpu_torch.models.data import synthetic_images
from metaopt_tpu_torch.models.transformer import _TRUNC_STD, init_dense_like_flax
from metaopt_tpu_torch.utils.device import resolve_device

#: layers-per-stage tables for the classic depths
STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
          101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BOTTLENECK = {50, 101, 152}

_BN_EPS = 1e-5  # flax nn.BatchNorm default
#: the convolutions' dtype: flax's hard-coded bf16 (the tests swap in a full
#: precision to hold the gradient, whose bf16 rounding is too coarse to compare)
_CONV_DTYPE = torch.bfloat16


def _same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax's (XLA's) 'SAME' padding of one spatial axis: (low, high)."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """flax ``Conv(use_bias=False, dtype=bf16)`` with 'SAME' padding."""
    k, s = conv.kernel_size[0], conv.stride[0]
    (top, bottom), (left, right) = (_same_padding(x.shape[2], k, s),
                                    _same_padding(x.shape[3], k, s))
    x = x.to(_CONV_DTYPE)
    w = conv.weight.to(_CONV_DTYPE)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=s, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=s)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(dtype=f32)`` over the channels of an NCHW input.

    ``momentum`` is flax's: the running averages become ``momentum * avg +
    (1 - momentum) * batch``. In training the batch statistics normalize the
    input and, in f32 and without grad, update the running mean and the
    running *biased* variance; in eval the running averages normalize.
    """

    def __init__(self, channels: int, momentum: float = 0.99, zero_scale: bool = False):
        super().__init__()
        self.momentum = float(momentum)
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, _BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, _BN_EPS)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (strided) → 1×1 (×4 channels), with a 1×1 projection of
    the residual where the shape changes. Blocks use flax momentum 0.9."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int = 1):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = nn.Conv2d(in_channels, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters, 0.9)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride=strides, bias=False)
        self.bn2 = BatchNorm(filters, 0.9)
        self.conv3 = nn.Conv2d(filters, out, 1, bias=False)
        self.bn3 = BatchNorm(out, 0.9, zero_scale=True)
        self.proj = self.proj_bn = None
        if in_channels != out or strides != 1:
            self.proj = nn.Conv2d(in_channels, out, 1, stride=strides, bias=False)
            self.proj_bn = BatchNorm(out, 0.9)
        self.out_channels = out

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(self.conv1, x), train))
        y = F.relu(self.bn2(_conv(self.conv2, y), train))
        y = self.bn3(_conv(self.conv3, y), train)
        residual = x if self.proj is None else self.proj_bn(_conv(self.proj, x), train)
        return F.relu(y + residual)


class BasicBlock(nn.Module):
    """3×3 (strided) → 3×3, with a 1×1 projection of the residual where the
    shape changes. Blocks use flax momentum 0.9."""

    def __init__(self, in_channels: int, filters: int, strides: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, filters, 3, stride=strides, bias=False)
        self.bn1 = BatchNorm(filters, 0.9)
        self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)
        self.bn2 = BatchNorm(filters, 0.9, zero_scale=True)
        self.proj = self.proj_bn = None
        if in_channels != filters or strides != 1:
            self.proj = nn.Conv2d(in_channels, filters, 1, stride=strides, bias=False)
            self.proj_bn = BatchNorm(filters, 0.9)
        self.out_channels = filters

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(self.conv1, x), train))
        y = self.bn2(_conv(self.conv2, y), train)
        residual = x if self.proj is None else self.proj_bn(_conv(self.proj, x), train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """CIFAR ResNet: 3×3 stem conv (stride 1, no max-pool) and its batch
    norm (flax's default momentum 0.99), the stages of ``STAGES[depth]``,
    a spatial mean and an f32 dense head. Input NHWC, output logits."""

    def __init__(self, depth: int = 50, n_classes: int = 10, width: int = 64):
        super().__init__()
        block = Bottleneck if depth in BOTTLENECK else BasicBlock
        self.stem = nn.Conv2d(3, width, 3, bias=False)  # RGB
        self.stem_bn = BatchNorm(width)
        blocks, ch = [], width
        for i, n_blocks in enumerate(STAGES[depth]):
            for j in range(n_blocks):
                blocks.append(block(ch, width * 2 ** i, 2 if i > 0 and j == 0 else 1))
                ch = blocks[-1].out_channels
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(ch, n_classes)

    @torch.no_grad()
    def init_like_flax(self, generator: torch.Generator) -> "ResNet":
        """Re-initialize as flax does, from ``generator`` (on the
        parameters' device): lecun-normal conv and dense kernels truncated
        to two standard deviations, zero biases, batch-norm scales one (zero
        for each block's last) and running averages 0 and 1."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif isinstance(mod, nn.Linear):
                init_dense_like_flax(mod, generator)
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(0.0 if mod.zero_scale else 1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        return self

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC storage seen as NCHW: channels_last, no copy
        x = F.relu(self.stem_bn(_conv(self.stem, x), train))
        for block in self.blocks:
            x = block(x, train)
        return F.linear(x.mean(dim=(2, 3)), self.head.weight, self.head.bias)


def _index(name: str) -> int:
    return int(name.rsplit("_", 1)[1])


def _kernel(a) -> torch.Tensor:
    """flax conv kernel (kh, kw, in, out) → PyTorch weight (out, in, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(3, 2, 0, 1)))


def _vec(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def params_from_flax(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``ResNet``'s ``params`` and ``batch_stats`` as this module's
    ``state_dict``.

    flax names submodules ``Type_i`` in creation order: the stem is
    ``Conv_0``/``BatchNorm_0``, the blocks ``Bottleneck_i`` (or
    ``BasicBlock_i``), the head ``Dense_0``. Inside a block the convs and
    norms come in call order, the projection last (``Conv_3``/
    ``BatchNorm_3`` in a bottleneck, ``Conv_2``/``BatchNorm_2`` in a basic
    block). Names are parsed by index: sorted as strings, ``Bottleneck_10``
    would come before ``Bottleneck_2``.
    """
    out: Dict[str, torch.Tensor] = {}

    def norm(prefix: str, p, s) -> None:
        out[f"{prefix}.weight"] = _vec(p["scale"])
        out[f"{prefix}.bias"] = _vec(p["bias"])
        out[f"{prefix}.running_mean"] = _vec(s["mean"])
        out[f"{prefix}.running_var"] = _vec(s["var"])

    out["stem.weight"] = _kernel(params["Conv_0"]["kernel"])
    norm("stem_bn", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    blocks = sorted((k for k in params if k.startswith(("Bottleneck_", "BasicBlock_"))),
                    key=_index)
    for i, name in enumerate(blocks):
        p, s = params[name], batch_stats[name]
        n_convs = sum(k.startswith("Conv_") for k in p)
        body = 3 if name.startswith("Bottleneck_") else 2
        for c in range(n_convs):
            conv, bn = (f"conv{c + 1}", f"bn{c + 1}") if c < body else ("proj", "proj_bn")
            out[f"blocks.{i}.{conv}.weight"] = _kernel(p[f"Conv_{c}"]["kernel"])
            norm(f"blocks.{i}.{bn}", p[f"BatchNorm_{c}"], s[f"BatchNorm_{c}"])
    out["head.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(params["Dense_0"]["kernel"], np.float32).T))
    out["head.bias"] = _vec(params["Dense_0"]["bias"])
    return out


class SGD:
    """``optax.chain(add_decayed_weights(wd), sgd(lr, momentum,
    nesterov=True))`` in ``torch._foreach`` ops over the model's parameters.

    The decay applies to every parameter (batch-norm scales and biases
    included): g ← g + wd·p; the trace starts at zero, t ← g + m·t; the
    update is g + m·t, scaled by −lr. ``torch.optim``'s first optimizer in
    a process imports ``torch._dynamo``; a trial run as its own process
    would pay that once per trial, and this class imports nothing.
    """

    def __init__(self, params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0):
        self.params = list(params)
        self.lr, self.momentum, self.weight_decay = float(lr), float(momentum), float(weight_decay)
        self.trace = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = torch._foreach_add([p.grad for p in self.params], self.params,
                                   alpha=self.weight_decay)
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, grads)
        updates = torch._foreach_add(grads, self.trace, alpha=self.momentum)
        torch._foreach_add_(self.params, updates, alpha=-self.lr)


def loss_fn(model: ResNet, x: torch.Tensor, y: torch.Tensor, *, train: bool = False) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    return F.cross_entropy(model(x, train=train), y)


def train_step(model: ResNet, opt: SGD, x: torch.Tensor, y: torch.Tensor,
               generator: torch.Generator, batch_size: int) -> torch.Tensor:
    """One SGD step on ``randperm(n)[:batch_size]`` of ``(x, y)``, drawn
    from ``generator`` on the data's device; returns the (detached) loss."""
    idx = torch.randperm(x.shape[0], generator=generator, device=x.device)[:batch_size]
    loss = loss_fn(model, x[idx], y[idx], train=True)
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss.detach()


def train_and_eval(
    hparams: Dict[str, Any],
    *,
    depth: int = 50,
    n_train: int = 4096,
    n_val: int = 1024,
    epochs: int = 1,
    seed: int = 0,
    hw: int = 32,
    on_epoch: Optional[Callable[[int, float], None]] = None,
    device=None,
    report: Optional[Dict[str, Any]] = None,
) -> float:
    """Train on synthetic CIFAR-shaped data; return the validation error.

    Each step trains on ``randperm(n_train)[:batch_size]`` drawn from an
    explicit generator on the device (no epoch shuffle); an epoch is
    ``max(1, n_train // batch_size)`` steps. ``on_epoch(epoch, val_error)``
    fires after each epoch so multi-fidelity scripts can stream partials
    (``client.report_partial``) from ONE continuous training run — the
    fidelity axis continues training, it never restarts. The validation
    error uses the running averages.

    ``report``, when given, receives ``setup_s`` (model, data and optimizer
    before the loop), ``train_s`` (the step loops, device-synchronized),
    ``eval_s`` (the validation passes), ``steps``, ``losses`` (mean
    training loss per epoch) and ``trial_s`` (the whole call).
    """
    t_call = time.perf_counter()
    device = resolve_device(device)
    lr = float(hparams.get("lr", 0.1))
    momentum = float(hparams.get("momentum", 0.9))
    weight_decay = float(hparams.get("weight_decay", 1e-4))
    batch_size = int(hparams.get("batch_size", 128))

    model = ResNet(depth=int(hparams.get("depth", depth)), width=int(hparams.get("width", 64)))
    model.to(device, memory_format=torch.channels_last)
    model.init_like_flax(torch.Generator(device=device).manual_seed(seed))
    x, y = synthetic_images(n_train, hw=hw, channels=3, seed=2 * seed, device=device)
    xv, yv = synthetic_images(n_val, hw=hw, channels=3, seed=2 * seed + 1, device=device)
    opt = SGD(model.parameters(), lr, momentum, weight_decay)
    gen = torch.Generator(device=device).manual_seed(seed)
    steps = max(1, n_train // batch_size)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def val_error() -> float:
        with torch.no_grad():
            return float(1.0 - (model(xv).argmax(-1) == yv).float().mean())

    sync()
    setup_s = time.perf_counter() - t_call
    train_s = eval_s = 0.0
    epoch_losses = []
    err = 1.0
    for e in range(int(epochs)):
        t0 = time.perf_counter()
        total = torch.zeros((), device=device)
        for _ in range(steps):
            total += train_step(model, opt, x, y, gen, batch_size)
        epoch_losses.append(total / steps)
        sync()
        t1 = time.perf_counter()
        train_s += t1 - t0
        if on_epoch is not None:
            err = val_error()
            eval_s += time.perf_counter() - t1
            on_epoch(e + 1, err)
    if on_epoch is None:
        t1 = time.perf_counter()
        err = val_error()
        eval_s += time.perf_counter() - t1
    if report is not None:
        report.update(setup_s=setup_s, train_s=train_s, eval_s=eval_s,
                      steps=steps * int(epochs), losses=[float(v) for v in epoch_losses],
                      trial_s=time.perf_counter() - t_call)
    return err


def make_objective(**fixed):
    """Objective for InProcessExecutor: params dict → validation error."""

    def objective(params: Dict[str, Any]) -> float:
        kw = dict(fixed)
        if "epochs" in params:
            kw["epochs"] = int(params["epochs"])  # ASHA fidelity
        return train_and_eval(params, **kw)

    return objective
