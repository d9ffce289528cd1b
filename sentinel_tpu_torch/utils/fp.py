"""Float32 arithmetic that matches the JAX reference bit for bit.

XLA's CPU backend contracts a float32 multiply feeding an add into one
fused multiply-add (one rounding); PyTorch eager rounds the product and
the sum separately, on the CPU and on CUDA alike. Where the product is
not exact — the warm-up controller's slope math, the token refills, the
cluster acquire scan's admission test — the two differ by an ulp, and a
threshold that lands on an integer (the warm-up ``warning_qps`` of a
cold bucket is 10.0 exactly in real arithmetic) then admits one request
more or less. ``fma32`` computes ``a * b + c`` with the single rounding
of C's ``fmaf`` and CUDA's ``__fmaf_rn``.

Not every multiply-add is contracted: in the step's program at batch
width 1 the warm-up ``warning_qps`` rounds twice in the reference, so
``models/flow.py`` follows it there (``tests/test_torch_models.py``).
"""

from __future__ import annotations

import torch


def _f64(x, like: torch.Tensor) -> torch.Tensor:
    if not torch.is_tensor(x):  # a Python scalar is a float32 operand
        x = torch.tensor(x, dtype=torch.float32, device=like.device)
    return x.to(torch.float64)


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with exactly one rounding; ``b`` and ``c``
    may be tensors or Python scalars.

    The float64 product of two float32 values is exact; the float64 sum
    is made round-to-odd (its TwoSum error decides whether to step to the
    odd neighbour), and a round-to-odd float64 rounds to the correctly
    rounded float32, since float64 keeps more than 24 + 1 bits."""
    p = a.to(torch.float64) * _f64(b, a)
    c64 = _f64(c, a)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, float("inf")),
                       torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)
