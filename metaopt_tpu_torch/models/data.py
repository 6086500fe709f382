"""Synthetic on-device datasets (port of ``metaopt_tpu/models/data.py``).

Trimmed to :func:`synthetic_images` (the MLP objective's data) and
:func:`synthetic_seq2seq` (the Transformer's). Data is generated directly
on the device with an explicit ``torch.Generator``; it keeps the
reference's semantics but not its bits (torch's generators, not
threefry), so tests feed both packages the same numpy data.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch


def synthetic_images(
    n: int,
    hw: int = 28,
    channels: int = 1,
    n_classes: int = 10,
    seed: int = 0,
    teacher_seed: int = 7,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MNIST/CIFAR-shaped images (n, hw, hw, channels) with labels from a
    fixed random linear teacher: ``argmax(x.reshape(n, -1) @ teacher)``.

    The teacher is keyed by ``teacher_seed`` alone, not by ``seed``, so
    train and validation draws share one labeling function.
    """
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, hw, hw, channels), generator=gen, device=device)
    teacher_gen = torch.Generator(device=device).manual_seed(teacher_seed)
    teacher = torch.randn((hw * hw * channels, n_classes), generator=teacher_gen,
                          device=device) / hw
    y = torch.argmax(x.reshape(n, -1) @ teacher, dim=-1)
    return x, y


def synthetic_seq2seq(
    n: int,
    seq_len: int = 64,
    vocab: int = 1000,
    seed: int = 0,
    teacher_seed: int = 7,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy-through-permutation task: the target is the source mapped
    through a fixed random vocabulary permutation — translation-shaped and
    learnable. Sources are drawn from [2, vocab) (0 = pad, 1 = bos); the
    permutation is keyed by ``teacher_seed`` alone, so separate train and
    validation draws share one "language"."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    src = torch.randint(2, vocab, (n, seq_len), generator=gen, device=device)
    teacher = torch.Generator(device=device).manual_seed(teacher_seed)
    perm = torch.randperm(vocab, generator=teacher, device=device)
    return src, perm[src]
