"""Device selection and host-sync accounting.

``resolve_device(None)`` is ``cuda`` — and raises when no CUDA device is
present, so a missing card is a loud error and never a silent CPU run.
Callers (the tests, the parity phase of ``chip_smoke.py``) pass
``device="cpu"`` to ask for the plain CPU path explicitly.

``host_bool`` is the port's ``lax.cond`` / ``lax.while_loop`` predicate:
a Python branch on a device bool, which costs one device->host sync on
CUDA. Every such branch goes through it so ``SYNCS.count`` can report
the syncs per step.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sentinel_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "CPU path explicitly")
        return torch.device("cuda")
    return torch.device(device)


class _SyncCounter:
    __slots__ = ("count",)

    def __init__(self):
        self.count = 0


SYNCS = _SyncCounter()


def host_bool(t) -> bool:
    """Read a 0-d device bool on the host (one sync on CUDA), counted."""
    SYNCS.count += 1
    return bool(t)
