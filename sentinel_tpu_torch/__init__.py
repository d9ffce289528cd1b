"""sentinel-tpu on PyTorch and CUDA: the fused admission/commit step and a
slim engine, ported from the JAX package ``sentinel_tpu``.

Layout mirrors the JAX package module for module (``core/``, ``ops/``,
``models/``, ``telemetry/``); each port module names its counterpart. The
JAX package stays the reference: the ``tests/test_torch_*.py`` parity
tests feed both packages the same numpy inputs.

Device policy: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``. With no CUDA device and no explicit device, the engine
raises (``utils/device.py``) — it never quietly runs on the CPU. On a CUDA
tensor the segmented prefix launches the hand-written kernel
(``csrc/segmented_prefix.cu``); on a CPU tensor it runs the plain torch
version of the same function.

This package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``sentinel_tpu``.
"""

from __future__ import annotations

__version__ = "0.1.0"
