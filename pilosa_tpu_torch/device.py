"""Device selection for the port's entry points.

A node serves from a list of parts, as the TPU package serves from every
local chip (`jax.local_devices()`): `resolve_devices` turns `--device`
(or `Executor(holder, device=...)`) into that list. `cuda` alone means
every visible card; `cuda:N` one card; a comma list (or a Python list)
names the parts, a card repeated to split it, as the TPU package's tests
split one host over forced CPU devices; `cpu` the CPU.
"""

import torch


def _one(dev):
    dev = torch.device(dev)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(server --device cpu) to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise ValueError(
                f"{dev} names no visible card "
                f"({torch.cuda.device_count()} visible)")
    return dev


def resolve_devices(device=None, rank=None):
    """The node's parts, a list of torch.device: `device` is None (cuda),
    a torch.device, a name, a comma-separated string of names or a list
    of them. A bare `cuda` expands to every visible card, or, with
    `rank` given (a `--spmd` process keeps one card), to
    `cuda:{rank mod visible cards}`. Raises when CUDA was asked for and
    is absent, or a name is no visible card."""
    if device is None:
        device = "cuda"
    if isinstance(device, str):
        names = [d.strip() for d in device.split(",") if d.strip()]
    elif isinstance(device, (list, tuple)):
        names = list(device)
    else:
        names = [device]
    if not names:
        raise ValueError("no device named")
    out = []
    for name in names:
        dev = _one(name)
        if dev.type == "cuda" and dev.index is None:
            n = torch.cuda.device_count()
            if rank is not None:
                out.append(torch.device("cuda", int(rank) % n))
            else:
                out.extend(torch.device("cuda", i) for i in range(n))
        else:
            out.append(dev)
    if len({d.type for d in out}) > 1:
        raise ValueError("a node's parts lie all on cards or all on the CPU")
    return out
