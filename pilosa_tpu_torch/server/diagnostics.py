"""Diagnostics phone-home (reference: diagnostics.go:41-260 + the hourly
loop server.go:760-810).

Collects anonymized cluster info and POSTs it to a configured endpoint on an
interval, and parses the response for a newer-version notice. Disabled by
default (`diagnostics.enabled = false`, and unlike the reference there is no
default public endpoint — an explicit URL is required), so nothing ever
leaves the host unless an operator opts in.
"""

import json
import threading
import time
import urllib.request

from .. import __version__


def _version_tuple(v):
    return tuple(int(p) for p in str(v).strip().lstrip("v").split(".")[:3]
                 if p.isdigit())


class Diagnostics:
    def __init__(self, api, endpoint, interval=3600.0, logger=None):
        from ..utils.logger import NopLogger

        self.api = api
        self.endpoint = endpoint
        self.interval = max(float(interval), 10.0)
        self.logger = logger if logger is not None else NopLogger()
        self.last_response = None
        self._stop = threading.Event()
        self._thread = None
        self._t0 = time.time()

    # -- payload (reference: diagnostics.go EnrichWithOSInfo/CheckVersion) ---

    def payload(self):
        """Anonymized cluster snapshot: counts and versions only — no
        index/field names, keys, or addresses (reference: diagnostics.go
        sends similarly shaped metrics)."""
        import platform

        import torch

        holder = self.api.holder
        indexes = list(holder.indexes.values())
        n_fields = sum(len(i.fields) for i in indexes)
        n_shards = sum(len(i.available_shards()) for i in indexes)
        cluster = getattr(self.api, "cluster", None)
        # the platform: torch, its CUDA, and the card the executor runs
        # on (a CPU executor reports no card and initializes no CUDA)
        device = self.api.device
        backend, n_devices, device_name = device.type, 0, None
        if device.type == "cuda":
            n_devices = torch.cuda.device_count()
            device_name = torch.cuda.get_device_name(device)
        return {
            "version": __version__,
            "os": platform.system(),
            "python": platform.python_version(),
            "numIndexes": len(indexes),
            "numFields": n_fields,
            "numShards": n_shards,
            "numNodes": len(cluster.nodes) if cluster else 1,
            "replicaN": cluster.replica_n if cluster else 1,
            "backend": backend,
            "numDevices": n_devices,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "deviceName": device_name,
            "uptimeSeconds": int(time.time() - self._t0),
        }

    def flush(self):
        """One POST + version check; never raises (reference: diagnostics
        errors are logged and ignored)."""
        try:
            req = urllib.request.Request(
                self.endpoint, data=json.dumps(self.payload()).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                body = resp.read()
            self.last_response = json.loads(body) if body else {}
            self.check_version(self.last_response)
        except Exception as e:
            self.logger.debugf("diagnostics flush failed: %s", e)

    def check_version(self, response):
        """Log when the endpoint reports a newer version (reference:
        diagnostics.CheckVersion diagnostics.go:179)."""
        latest = (response or {}).get("version")
        if latest and _version_tuple(latest) > _version_tuple(__version__):
            self.logger.printf(
                "newer pilosa_tpu_torch version available: %s "
                "(running %s)",
                latest, __version__)
            return True
        return False

    # -- loop ----------------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name="pilosa-diagnostics", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        self.flush()
        while not self._stop.wait(self.interval):
            self.flush()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
