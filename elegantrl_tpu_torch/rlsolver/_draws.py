"""Devices and random draws of the solver layer.

Each stochastic function takes ``gen``: a ``torch.Generator`` on the
solver's device (the JAX package's ``key``), an int seed for a new one, or
a :class:`Draws`.  A ``Draws`` hands out every random tensor a function
needs by name, from its generator, or replayed from given draws
(``draws=``, a mapping from each name to its draws in the order they are
taken: one entry a call), so a test can run the port on the JAX package's
draws and compare the two draw for draw.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Mapping, Optional

import numpy as np
import torch


def solver_device(device, owner: str) -> torch.device:
    """``device`` as a ``torch.device``: None is the card, as for
    ``Config``; the card without a GPU raises (``config.resolve_device``)."""
    from ..config import resolve_device
    return resolve_device(SimpleNamespace(device='cuda' if device is None else device),
                          owner=owner)


class Draws:
    """The random draws of one call of a stochastic function, by name: made
    from ``gen`` (a ``torch.Generator`` on ``device``, or an int seed), or,
    with ``given``, taken in order from ``given[name]``."""

    def __init__(self, gen=None, device: torch.device = torch.device('cpu'),
                 given: Optional[Mapping] = None):
        self.device = torch.device(device)
        self.given = given
        self.taken = {}
        self.gen = None
        if given is None:
            if isinstance(gen, torch.Generator):
                self.gen = gen
            else:
                self.gen = torch.Generator(device=self.device)
                self.gen.manual_seed(0 if gen is None else int(gen))

    def __call__(self, name: str, make: Callable[[torch.Generator], torch.Tensor],
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The next draw of ``name``: ``make(gen)``, or the next given one."""
        if self.given is None:
            return make(self.gen)
        i = self.taken.get(name, 0)
        self.taken[name] = i + 1
        return torch.tensor(np.asarray(self.given[name][i]), device=self.device).to(dtype)

    def rand(self, name: str, shape) -> torch.Tensor:
        """Uniform float32 in [0, 1)."""
        return self(name, lambda g: torch.rand(shape, generator=g, device=self.device))

    def bernoulli(self, name: str, p: float, shape) -> torch.Tensor:
        """0/1 float32, 1 with probability ``p`` (a uniform below ``p``)."""
        return self(name, lambda g: (torch.rand(shape, generator=g, device=self.device)
                                     < p).to(torch.float32))

    def randint(self, name: str, high: int, shape) -> torch.Tensor:
        """int64 uniform on ``[0, high)``."""
        return self(name, lambda g: torch.randint(0, int(high), shape, generator=g,
                                                  device=self.device), torch.int64)

    def normal(self, name: str, shape) -> torch.Tensor:
        return self(name, lambda g: torch.randn(shape, generator=g, device=self.device))

    def gumbel(self, name: str, shape) -> torch.Tensor:
        """Standard Gumbel noise, ``-log(-log(u))`` with u in [tiny, 1)."""
        tiny = torch.finfo(torch.float32).tiny
        return self(name, lambda g: -torch.log(-torch.log(
            torch.rand(shape, generator=g, device=self.device).clamp_(min=tiny))))


def as_draws(gen, device: torch.device, draws: Optional[Mapping] = None) -> Draws:
    """``gen`` as a :class:`Draws` on ``device`` (a ``Draws`` as given);
    with ``draws`` one that replays them."""
    if isinstance(gen, Draws):
        return gen
    return Draws(gen, device, draws)
