"""Pixel-observation PointChasing (counterpart of
``elegantrl_tpu/envs/pixel_chasing.py``): the chasing task of
``point_chasing.py`` rendered as a (64, 64, 2) image each step, channel 0 a
Gaussian blob at the walker, channel 1 at the agent, values in [0, 255]
(the ConvNet rescales by ``/128 - 1``).  The feed of ``AgentPixelPPO``.
"""

from __future__ import annotations

import torch

from .base import EnvDef, EnvSpec, VecEnv
from .point_chasing import ChasingState, _make_init, _step

_SIZE = 64
_EXTENT = 14.0      # the world's [-EXTENT, EXTENT] maps onto the image
_BLOB_SIGMA = 0.7   # world units (~1.6 px)


def _render(s: ChasingState) -> torch.Tensor:
    """(N, 64, 64, 2) float32 images; rows are y, columns x."""
    grid = torch.linspace(-_EXTENT, _EXTENT, _SIZE, device=s.p0.device)

    def blob(p):   # (N, 2) -> (N, 64, 64), the outer product gy gx
        gx = torch.exp(-torch.square(grid - p[:, 0:1]) / (2 * _BLOB_SIGMA ** 2))
        gy = torch.exp(-torch.square(grid - p[:, 1:2]) / (2 * _BLOB_SIGMA ** 2))
        return gy[:, :, None] * gx[:, None, :]

    return torch.stack([blob(s.p0), blob(s.p1)], dim=-1) * 255.0


def make_pixel_chasing() -> EnvDef:
    spec = EnvSpec(env_name='PixelChasing-v0', num_envs=1, max_step=200,
                   state_dim=(_SIZE, _SIZE, 2), action_dim=2, if_discrete=False)
    return EnvDef(spec=spec, init=_make_init(2), obs=_render, step=_step)


class PixelChasingEnv(VecEnv):
    def __init__(self, num_envs: int = 1, seed: int = 0, device: str = None, **_kwargs):
        super().__init__(make_pixel_chasing(), num_envs=num_envs, seed=seed, device=device)
