"""Seeded fields: the one generator every traffic mix goes through.

A traffic file's ``draw`` entry names a distribution and its parameters;
:func:`draw` makes the field of one cycle of the traffic, from the run's
seed and the cycle's number, on the device, in float64 and in one call, so
that the same seed gives the same fields on every run and each cycle a
fresh one.
"""

from __future__ import annotations

import torch

DISTRIBUTIONS = ("normal", "constant")
_MIX = 0x9E3779B97F4A7C15  # odd; spreads (seed, cycle) over 64 bits


def generator(seed: int, cycle: int, device) -> torch.Generator:
    """A generator on ``device`` for cycle ``cycle`` of seed ``seed`` (seeds
    may run past 32 bits; ``manual_seed`` takes 63)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * _MIX + int(cycle) * (_MIX >> 7) + int(cycle)) % (2**63))
    return g


def draw(spec: dict, seed: int, cycle: int, n: int, device) -> torch.Tensor:
    """``n`` float64 values drawn by ``spec``: ``{"dist": "normal"}``
    (independent N(0, 1)) or ``{"dist": "constant", "low": a, "high": b}``
    (one value, uniform on [a, b), in every place)."""
    dist = spec["dist"]
    if dist not in DISTRIBUTIONS:
        raise ValueError(f"unknown distribution {dist!r}; choose from {DISTRIBUTIONS}")
    g = generator(seed, cycle, device)
    if dist == "normal":
        return torch.randn(n, generator=g, device=device, dtype=torch.float64)
    c = torch.rand(1, generator=g, device=device, dtype=torch.float64)
    return (spec["low"] + (spec["high"] - spec["low"]) * c).expand(n).contiguous()
