"""Semantic-search goal policy (port of ``mass_tpu.search.policy``).

A small fully-convolutional network over the top-down (z-collapsed)
semantic map scores every map cell as an exploration goal; goals are
drawn from the softmax over cells with the threefry stream of
:mod:`mass_tpu_torch.search.prng`, so a seeded draw picks the cell the
JAX package picks.  The layout is the reference's ``policy.pth``: a
``Sequential`` of five 3x3 convs, the first four each followed by a
one-group GroupNorm and a ReLU (indices 0-12).  The convs run in
float32 with TF32 off and deterministic cuDNN algorithms.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from mass_tpu_torch.search import prng
from mass_tpu_torch.utils.checkpoint import load_state_dict
from mass_tpu_torch.utils.training import flax_init_

NUM_CLASSES = 54  # OccupiedSpace + 43 pickable + 10 openable
CONV_INDICES = (0, 3, 6, 9, 12)
NORM_INDICES = (1, 4, 7, 10)


class SearchPolicy(nn.Sequential):
    """Five-conv heat-map network: ``[B, H, W, C]`` -> ``[B, H, W, 1]``
    logits (the input is permuted to NCHW here)."""

    def __init__(self, in_channels: int = NUM_CLASSES, hidden: int = 64):
        layers = []
        width = in_channels
        for _ in NORM_INDICES:
            layers += [nn.Conv2d(width, hidden, 3, padding=1),
                       nn.GroupNorm(1, hidden, eps=1e-5), nn.ReLU()]
            width = hidden
        layers.append(nn.Conv2d(hidden, 1, 3, padding=1))
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous()
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=False):
            out = super().forward(x)
        return out.permute(0, 2, 3, 1)


def input_channels(policy: SearchPolicy) -> int:
    """The input width the checkpoint was trained with: the first conv's
    input channels (``2 * NUM_CLASSES`` for a walkthrough-conditioned
    checkpoint, ``NUM_CLASSES`` for a plain one)."""
    return int(policy[0].in_channels)


@torch.no_grad()
def goal_logits(policy: SearchPolicy, top_down: torch.Tensor
                ) -> torch.Tensor:
    """Flat per-cell goal logits ``[B, H*W]`` of a top-down map
    ``[B, H, W, C]``."""
    out = policy(top_down)
    b, h, w, _ = out.shape
    return out.reshape(b, h * w)


def sample_goal_cell(policy: SearchPolicy, top_down: torch.Tensor,
                     key: torch.Tensor) -> torch.Tensor:
    """One goal cell per batch element from the softmax over cells:
    ``[B, 3]`` map coordinates ``(x, y, 0)``."""
    logits = goal_logits(policy, top_down)
    idx = prng.categorical(key, logits)
    h, w = top_down.shape[1], top_down.shape[2]
    x = idx % w
    y = (idx // w) % h
    return torch.stack([x, y, torch.zeros_like(idx)], dim=-1)


def inhibited_sample_cell(logits, height: int, width: int,
                          prior_cells: Sequence, radius: float,
                          key: torch.Tensor) -> np.ndarray:
    """Without-replacement policy decoding on the host: zero the softmax
    within ``radius`` cells of ``prior_cells`` (this phase's earlier
    policy goals; never all of it), then draw by inverse CDF with one
    float32 uniform from ``key``.  Returns ``[x, y, 0]`` (int64)."""
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().cpu().numpy()
    logits = np.asarray(logits, np.float64)
    p = np.exp(logits - logits.max())
    if prior_cells:
        xs = np.arange(width)[None, :]
        ys = np.arange(height)[:, None]
        r2 = radius ** 2
        keep = np.ones((height, width), bool)
        for c in prior_cells:
            keep &= ((xs - c[0]) ** 2 + (ys - c[1]) ** 2) > r2
        masked = p * keep.ravel()
        if masked.sum() > 0:
            p = masked
    p /= p.sum()
    u = float(prng.uniform(key))
    idx = int(np.searchsorted(np.cumsum(p), u))
    idx = min(idx, height * width - 1)
    return np.asarray([idx % width, idx // width, 0], np.int64)


def init_policy(generator: torch.Generator, channels: int = NUM_CLASSES,
                hidden: int = 64) -> SearchPolicy:
    """A freshly initialised policy on the CPU, drawn from ``generator``
    with flax's defaults (the counterpart of the JAX package's
    ``init_params``; the draws are torch's, not ``jax.random``'s)."""
    return flax_init_(SearchPolicy(channels, hidden), generator)


def from_state_dict(state_dict: Dict[str, torch.Tensor],
                    device=None) -> SearchPolicy:
    """A :class:`SearchPolicy` holding the reference ``policy.pth``
    weights (a ``Sequential`` state dict, convs at 0, 3, 6, 9, 12 and
    group norms at 1, 4, 7, 10), in eval mode on ``device``."""
    policy = SearchPolicy(
        in_channels=int(state_dict["0.weight"].shape[1]),
        hidden=int(state_dict["0.weight"].shape[0]))
    policy.load_state_dict(state_dict)
    return policy.to(device).eval()


def load_reference_policy(path: str, device=None) -> SearchPolicy:
    """Load a ``policy.pth`` state dict (read on the CPU) onto
    ``device``."""
    return from_state_dict(load_state_dict(path), device)
