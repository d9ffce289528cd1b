"""Device selection and host-sync accounting.

``resolve_device(None)`` is ``cuda`` — and raises when no CUDA device is
present, so a missing card is a loud error and never a silent CPU run.
Callers (the tests, the parity phase of ``chip_smoke.py``) pass
``device="cpu"`` to ask for the plain CPU path explicitly.

``host_bool`` is the port's ``lax.cond`` / ``lax.while_loop`` predicate:
a Python branch on a device bool, which costs one device->host sync on
CUDA. Every such branch goes through it so ``SYNCS.count`` can report
the syncs per step. Each call site names its counter,
``sync.<module>.<what>``, which counts it too while the span recorder
(``metrics/profiling.py``) is on.

``to_host`` brings a set of tensors to host numpy in one device-to-host
copy (the checkpoint's snapshot, the telemetry reader).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sentinel_tpu_torch.metrics import profiling as _prof


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


def host_bool(t, site: str) -> bool:
    """Read a 0-d device bool on the host (one sync on CUDA), counted;
    ``site`` is its counter's name, ``sync.<module>.<what>``."""
    SYNCS.count += 1
    _prof.count(site)
    return bool(t)


def to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every tensor to host numpy in ONE device-to-host copy: their bytes
    are packed into one uint8 buffer on the device, int64 parts first so
    every slice of the host buffer stays 8-byte aligned. The result owns
    fresh memory on every device (on the CPU too), so later in-place
    steps never reach it."""
    items = sorted(tensors.items(), key=lambda kv: -kv[1].element_size())
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for _, t in items])
    host = flat.cpu().numpy()
    out, off = {}, 0
    for name, t in items:
        n = t.numel() * t.element_size()
        dtype = np.dtype(str(t.dtype).replace("torch.", ""))
        out[name] = host[off:off + n].view(dtype).reshape(tuple(t.shape))
        off += n
    return {name: out[name] for name in tensors}
