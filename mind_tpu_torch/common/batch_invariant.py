"""Products whose result for one scene does not depend on how many scenes
share the call.

A batched plan runs S scenes through one network forward and one solve,
and each scene must compute there what it computes alone. Library calls
break that: cuBLAS picks its kernel, and with it the order of its sums, by
the problem's shape (a batched product by the number of matrices, a plain
one by its number of rows), cuDNN its convolution algorithm by the batch,
and PyTorch's reductions spread a row over more threads when there are
few rows. Two ways around it:

- `mm` / `mv`: small matrix products as a broadcast product summed over the
  innermost axis, whose reduction is laid out by that axis and the (many)
  outputs alone (the solver, the scene preparation, the mode attention);
- `per_scene`: within `scenes(n)`, a call on a tensor whose leading axis
  holds n scenes' rows, scene-major, runs once per scene on that scene's
  rows, so every call has the shape of the scene's own call alone (the
  network's dense layers, convolutions, normalization statistics and
  Bezier products; AIME opens the context around each forward). The fusion
  kernels, which compute each node the same at any batch, and elementwise
  operations run once over all scenes.
"""

from __future__ import annotations

import contextlib

import torch

_SCENES = 1


def mm(a, b):
    """a @ b for small matrices [..., m, k] @ [..., k, n], as a broadcast
    product summed over k."""
    return (a.unsqueeze(-2) * b.transpose(-1, -2).unsqueeze(-3)).sum(-1)


def mv(a, v):
    """a @ v for [..., m, k] matrices and [..., k] vectors, as mm."""
    return (a * v.unsqueeze(-2)).sum(-1)


@contextlib.contextmanager
def scenes(n: int):
    """Within: per_scene splits its tensors' leading axis into n scenes."""
    global _SCENES
    outer, _SCENES = _SCENES, n
    try:
        yield
    finally:
        _SCENES = outer


def per_scene(fn, x, *args, **kwargs):
    """fn(x, *args, **kwargs), computed on each scene's rows of x alone and
    concatenated along the leading axis (one call outside `scenes`)."""
    if _SCENES == 1:
        return fn(x, *args, **kwargs)
    if x.shape[0] % _SCENES:
        raise ValueError(f"a leading axis of {x.shape[0]} does not hold {_SCENES} scenes")
    return torch.cat([fn(part, *args, **kwargs) for part in x.chunk(_SCENES)])
