"""Float32 arithmetic that matches the JAX reference bit for bit.

XLA's CPU backend contracts a float32 multiply feeding an add into one
fused multiply-add (one rounding); PyTorch eager rounds the product and
the sum separately, on the CPU and on CUDA alike. Where the product is
not exact — the warm-up controller's slope math, the token refills —
the two differ by an ulp, and a threshold that lands on an integer
(the warm-up ``warning_qps`` of a cold bucket is 10.0 exactly in real
arithmetic) then admits one request more or less. ``fma32`` computes
``a * b + c`` with the single rounding: the float64 product of two
float32 values is exact, the float64 sum rounds once more than a true
FMA would, which can differ from it only on an exact float32 halfway
tie.

Not every multiply-add is contracted: in the step's program at batch
width 1 the warm-up ``warning_qps`` rounds twice in the reference, so
``models/flow.py`` follows it there (``tests/test_torch_models.py``).
"""

from __future__ import annotations

import torch


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (see module docstring)."""
    a64 = a.to(torch.float64)
    b64 = b.to(torch.float64) if torch.is_tensor(b) else float(b)
    c64 = c.to(torch.float64) if torch.is_tensor(c) else float(c)
    return (a64 * b64 + c64).to(torch.float32)
