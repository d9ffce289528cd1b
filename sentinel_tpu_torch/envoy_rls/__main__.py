"""``python -m sentinel_tpu_torch.envoy_rls`` — standalone RLS token server
(port of ``sentinel_tpu/envoy_rls/__main__.py``).

Rules come from a JSON file (``SENTINEL_RLS_RULES`` or ``--rules``),
re-polled on mtime change so a ConfigMap update applies without restart::

    [{"domain": "web", "descriptors": [
        {"resources": [{"key": "path", "value": "/api"}], "count": 100}]}]

Device policy: the token service runs on ``cuda``; with no card and no
``--device`` the process exits 2 with :func:`resolve_device`'s error.
``--device cpu`` runs the plain CPU path when asked for. The service is
warmed before the port is bound, so the first call does not pay for the
acquire kernel's first launch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from sentinel_tpu_torch.envoy_rls.rule import (
    EnvoyRlsRule,
    EnvoyRlsRuleManager,
    KeyValueResource,
    ResourceDescriptor,
)
from sentinel_tpu_torch.envoy_rls.service import SentinelEnvoyRlsService
from sentinel_tpu_torch.utils.device import resolve_device

# Seconds between two looks at the rules file's mtime.
RELOAD_POLL_S = 3


def rules_from_json(text: str):
    out = []
    for d in json.loads(text or "[]"):
        out.append(EnvoyRlsRule(
            domain=d["domain"],
            descriptors=[
                ResourceDescriptor(
                    resources=[KeyValueResource(r["key"], r["value"])
                               for r in desc.get("resources", [])],
                    count=float(desc["count"]),
                )
                for desc in d.get("descriptors", [])
            ],
        ))
    return out


def reload_rules(manager: EnvoyRlsRuleManager, path: str, mtime):
    """One poll of the rules file: reload on an mtime change and return
    the new mtime, or keep the last good rules and return ``mtime`` when
    the file is unreadable or malformed. The mtime is recorded only on
    SUCCESS: a mid-write or malformed read retries next poll even when
    the final write lands in the same coarse mtime tick."""
    try:
        m = os.stat(path).st_mtime
    except OSError:
        return mtime
    if m == mtime:
        return mtime
    try:
        with open(path, "r", encoding="utf-8") as f:
            manager.load_rules(rules_from_json(f.read()))
        print("RLS rules reloaded", flush=True)
        return m
    except (OSError, ValueError, KeyError, TypeError) as ex:
        # Malformed/mid-write update: keep serving last-good.
        print(f"RLS rules reload FAILED (kept last good): {ex!r}",
              flush=True)
        return mtime


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sentinel_tpu_torch.envoy_rls",
        description="sentinel-tpu Envoy RLS server")
    ap.add_argument("--address",
                    default=os.environ.get("SENTINEL_RLS_ADDRESS",
                                           "0.0.0.0:10245"))
    ap.add_argument("--rules",
                    default=os.environ.get("SENTINEL_RLS_RULES", ""))
    ap.add_argument("--device", default=None,
                    help="torch device of the token service (default: cuda; "
                         "with no card the process exits unless --device "
                         "cpu asks for the CPU path)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as ex:
        ap.error(str(ex))

    manager = EnvoyRlsRuleManager()
    service = SentinelEnvoyRlsService(manager, device=device)
    mtime = None
    if args.rules:
        with open(args.rules, "r", encoding="utf-8") as f:
            manager.load_rules(rules_from_json(f.read()))
        mtime = os.stat(args.rules).st_mtime
    # Warm the token service before binding: on the card the probe loads
    # and launches the acquire kernel. A no-rule probe takes no quota.
    service.token_service.request_tokens([(None, 0, False)])
    server = service.serve_grpc(args.address)
    print(f"sentinel-tpu RLS serving on {args.address} "
          f"(port {server.bound_port})", flush=True)
    try:
        while True:
            time.sleep(RELOAD_POLL_S)
            if args.rules:
                mtime = reload_rules(manager, args.rules, mtime)
    except KeyboardInterrupt:
        server.stop(grace=1.0)
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
