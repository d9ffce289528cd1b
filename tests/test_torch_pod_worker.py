"""One process of a ``torch.distributed`` pod, for the distributed tests of
``tests/test_torch_namespaces.py`` (it holds no test of its own).

Run as ``python -m tests.test_torch_pod_worker RANK WORLD DIR``: the
process joins a gloo group through a ``FileStore`` in ``DIR`` (no network),
loads the rule pack, the shard state and the batch stream that the test
wrote to ``DIR/inputs.npz``, steps its own shard with
``make_dist_pod_steps`` and then with ``make_dist_dcn_pod_steps`` (one
slice per rank, global scope), and writes each run's decisions and final
state to ``DIR/out_RANK.npz``. It imports torch and the port only.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def flatten(d, prefix=""):
    """Nested dict of arrays -> {"a/b/c": array}."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat, prefix=""):
    """{"a/b/c": array} -> nested dict, for the keys under ``prefix``."""
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def batches(flat, kind, rank, world):
    """This rank's lanes of every ``kind`` batch of the stream, in step
    order."""
    out = []
    k = 0
    while f"{kind}{k}/cluster_row" in flat:
        full = unflatten(flat, f"{kind}{k}/")
        width = full["cluster_row"].shape[0] // world
        out.append({f: a[rank * width:(rank + 1) * width]
                    for f, a in full.items()})
        k += 1
    return out


def main(rank: int, world: int, where: str) -> None:
    import torch.distributed as dist

    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.core.batch import to_device
    from sentinel_tpu_torch.parallel import cluster as PPC
    from sentinel_tpu_torch.parallel import namespaces as PNS

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = dist.FileStore(os.path.join(where, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    with np.load(os.path.join(where, "inputs.npz")) as z:
        flat = {k: z[k] for k in z.files}
    times = flat["times"]
    entries = batches(flat, "entry", rank, world)
    exits = batches(flat, "exit", rank, world)
    out = {}
    runs = (("pod", PPC.make_dist_pod_steps(device="cpu")),
            ("dcn", PNS.make_dist_dcn_pod_steps(world, 1, device="cpu")))
    for name, (entry, exit_) in runs:
        rules = convert.rules_from_numpy(unflatten(flat, f"{name}_rules/"),
                                         "cpu")
        state = convert.state_from_numpy(unflatten(flat, "state/"), "cpu")
        for k, (ebuf, xbuf) in enumerate(zip(entries, exits)):
            state, dec = entry(state, rules, to_device(ebuf, "cpu"),
                               int(times[k]))
            for f in dec._fields:
                out[f"{name}/dec{k}/{f}"] = getattr(dec, f).numpy()
            state = exit_(state, rules, to_device(xbuf, "cpu"),
                          int(times[k]) + 20)
        out.update(flatten(convert.state_to_numpy(state),
                           f"{name}/state/"))
    dist.barrier()
    dist.destroy_process_group()
    np.savez(os.path.join(where, f"out_{rank}.npz"), **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
