"""Global reductions used by the solvers and the time stepper.

Single-device identities: the call sites (Krylov dot products, the
viscosity-iteration L2 norms, the truncation-error max, the advective CFL
min) go through this module so that a multi-device port only has to add
the collective here.
"""

from __future__ import annotations

import torch


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def sum_all(x):
    """Global sum over all elements."""
    return x.sum()


def max_all(x):
    return x.max()


def min_all(x):
    return x.min()


def dot(a, b):
    """Global dot product of two tensors or two tuples of tensors."""
    return sum((x * y).sum() for x, y in zip(_leaves(a), _leaves(b)))


def norm(x):
    """Global L2 norm of a tensor or a tuple of tensors."""
    return torch.sqrt(dot(x, x))
