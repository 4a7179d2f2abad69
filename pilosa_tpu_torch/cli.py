"""Command line (reference: cmd/ + ctl/ — cobra commands):
`python -m pilosa_tpu_torch <command>`.

Subcommands mirror the TPU package's single-node ones (reference:
cmd/root.go:71-78): server, import, backup, restore, export, inspect,
check, holder, generate-config, and config (prints the EFFECTIVE merged
configuration). Config comes from a TOML file, PILOSA_TPU_* env vars and
flags, in that order of precedence (reference: server/config.go).

The server opens the data directory (a `pilosa_tpu` data directory opens
as is: the roaring fragment files and the oplog records are the
interchange format), replays what its write-ahead oplog holds unapplied,
serves the HTTP API until SIGINT/SIGTERM, then closes the holder and the
log. Observability comes up with it, under the TPU package's flags and
config keys: the stats backend (`--stats`, `--statsd-host`), span
retention (`--tracing`), histogram exemplars (`--metrics-exemplars`),
the slow-query log (`--long-query-time`), the flight recorder
(`--flight-recorder-size`) and its stall watchdog
(`--watchdog-deadline`), the worker pool's size (`--workers`), the
runtime sampler, and a SIGTERM handler that dumps the flight recorder
and then runs the clean stop. Health comes up with it too: the
device-link canary prober behind /readyz (`--device-probe-interval`,
`--device-probe-deadline`), postmortem bundles (`--incident-dir`,
`--incident-max`), latency objectives (`--slo`,
`--slo-burn-threshold`) and the opt-in diagnostics phone-home
(`[diagnostics]` enabled + endpoint in the config file). With
`--tls-certificate`/`--tls-key` it serves HTTPS and SIGHUP reloads the
pair; `--allowed-origins` turns on CORS. `--ingest-merge-interval`
starts the streaming ingest engine (imports fold into the resident
stacks once an interval, off the read path); `--adaptive off|on|shadow`
the adaptive engine (priced strategies, K4 tiles, heat-scored
eviction); `--plan-ring-size` and `--explain-misestimate-factor` size
and tune the EXPLAIN ANALYZE ring; `--fusion off|on|shadow` (with
`--fusion-cache-size`, `--fusion-min-hits`) whole-plan fusion, a
multi-Count query as one fused dispatch; `--admission on` (with
`--admission-capacity`, `--admission-queue-depth`,
`--admission-queue-timeout`) the admission controller and its
degradation ladder. `--cluster-hosts` (every node's host:port, with
`--node-id` and `--replicas`) or `--join` (any member's host:port) makes
it one node of an HTTP cluster: each node serves its own shards on its
own device, the node a query reaches fans it out and merges, imports
reach every replica, a health monitor marks peers DOWN and READY, an
anti-entropy pass (`[anti-entropy] interval`, default 10m) repairs
replicas, keys replicate from their primary, and a joining node enters
through the coordinator's resize. It runs on `cuda` unless
`--device cpu` is given, and exits with an error when no CUDA device is
present and the CPU was not asked for.
`holder`, `inspect` and `check` read files only and touch no device.
"""

import argparse
import json
import os
import re
import signal
import sys
import threading

DEFAULT_CONFIG = {
    "bind": "127.0.0.1:10101",
    "data-dir": "~/.pilosa_tpu_torch",
    "max-op-n": 10000,
    "cluster": {"coordinator": True, "nodes": []},
    "anti-entropy": {"interval": "10m"},
}


def load_config(path=None):
    """TOML file < env < flags (reference: server/config.go)."""
    config = json.loads(json.dumps(DEFAULT_CONFIG))  # deep copy
    if path:
        try:
            import tomllib  # 3.11+
        except ImportError:
            try:
                import tomli as tomllib
            except ImportError:
                raise SystemExit(
                    "--config requires tomllib (Python 3.11+) or tomli")
        with open(path, "rb") as f:
            config.update(tomllib.load(f))
    if os.environ.get("PILOSA_TPU_BIND"):
        config["bind"] = os.environ["PILOSA_TPU_BIND"]
    if os.environ.get("PILOSA_TPU_DATA_DIR"):
        config["data-dir"] = os.environ["PILOSA_TPU_DATA_DIR"]
    return config


def parse_duration(s):
    """'10m', '30s', '500ms', '1h30m' -> seconds (Go time.ParseDuration
    forms); a bare number is seconds."""
    s = str(s).strip()
    units = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1, "m": 60, "h": 3600}
    parts = re.findall(r"(\d+(?:\.\d+)?)(ns|us|ms|s|m|h)", s)
    if not parts:
        return float(s)
    consumed = "".join(n + u for n, u in parts)
    if consumed != s:
        raise ValueError(f"invalid duration: {s!r}")
    return sum(float(n) * units[u] for n, u in parts)


def _toml_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    if isinstance(v, dict):  # inline table (e.g. [[cluster.nodes]] entries)
        inner = ", ".join(f"{k} = {_toml_value(v[k])}" for k in sorted(v))
        return "{" + inner + "}"
    return json.dumps(str(v))


def _apply_server_flags(config, args):
    """Fold server-command flags into a loaded config — the single merge
    used by `server`, `config` and `holder`, so what `config` prints is
    exactly what `server` runs with (reference: cmd/root.go setAllConfig
    does this once via viper for every subcommand)."""
    for flag in ("bind", "data_dir", "device", "cluster_hosts", "node_id",
                 "replicas", "max_writes_per_request",
                 "coalesce_window", "coalesce_max_queue", "container_repr",
                 "long_query_time", "tracing", "workers",
                 "flight_recorder_size", "watchdog_deadline",
                 "metrics_exemplars", "incident_dir", "incident_max",
                 "device_probe_interval", "device_probe_deadline",
                 "slo", "slo_burn_threshold", "plan_ring_size",
                 "explain_misestimate_factor", "adaptive",
                 "fusion", "fusion_cache_size", "fusion_min_hits",
                 "ingest_merge_interval",
                 "admission", "admission_capacity",
                 "admission_queue_depth", "admission_queue_timeout",
                 "spmd_port", "spmd_serve", "spmd_cpu_collectives",
                 "spmd_stream_gap_timeout"):
        val = getattr(args, flag, None)
        if val is not None:
            config[flag.replace("_", "-")] = val
    if getattr(args, "spmd", False):
        config["spmd"] = True
    # TLS and CORS live in config sub-tables ([tls], [handler]); fold the
    # flags into those tables so `config` prints them where the server
    # reads them (reference: server/config.go TLS + handler sections).
    if getattr(args, "tls_certificate", None) is not None \
            or getattr(args, "tls_key", None) is not None:
        tls = config.get("tls")
        if not isinstance(tls, dict):
            tls = config["tls"] = {}
        if getattr(args, "tls_certificate", None) is not None:
            tls["certificate"] = args.tls_certificate
        if getattr(args, "tls_key", None) is not None:
            tls["key"] = args.tls_key
    if getattr(args, "allowed_origins", None) is not None:
        handler = config.get("handler")
        if not isinstance(handler, dict):
            handler = config["handler"] = {}
        handler["allowed-origins"] = args.allowed_origins
    # Durability knobs live in [storage] — ONE fsync policy shared by the
    # write-ahead oplog and the fragment WALs (a split policy would make
    # the documented durability level a lie at whichever layer is weaker).
    if getattr(args, "fsync", None) is not None \
            or getattr(args, "no_oplog", False) \
            or getattr(args, "oplog_segment_bytes", None) is not None:
        storage = config.get("storage")
        if not isinstance(storage, dict):
            storage = config["storage"] = {}
        if getattr(args, "fsync", None) is not None:
            storage["fsync"] = args.fsync
        if getattr(args, "no_oplog", False):
            storage["oplog"] = False
        if getattr(args, "oplog_segment_bytes", None) is not None:
            storage["oplog-segment-bytes"] = args.oplog_segment_bytes
    return config


# -- server -------------------------------------------------------------------


class Server:
    """A started server: holder + API + HTTP transport, the oplog when the
    server keeps one, and the runtime sampler. `replayed` counts the
    records the boot replay applied; `watchdog`, `prober`, `incidents`
    and `diagnostics` are the stall watchdog, device-link prober,
    incident manager and diagnostics loop this server started (None when
    not configured)."""

    def __init__(self, holder, api, http, oplog=None, replayed=0,
                 runtime_monitor=None, watchdog=None, prober=None,
                 incidents=None, diagnostics=None, cluster_services=()):
        self.holder = holder
        self.api = api
        self.http = http
        self.oplog = oplog
        self.replayed = replayed
        self.runtime_monitor = runtime_monitor
        self.watchdog = watchdog
        self.prober = prober
        self.incidents = incidents
        self.diagnostics = diagnostics
        # a cluster node's background loops (translate replication,
        # anti-entropy, the peer health monitor), stopped in this order
        self.cluster_services = list(cluster_services)

    @property
    def cluster(self):
        return self.api.cluster

    @property
    def uri(self):
        return self.http.uri

    def stop(self):
        from .utils import devhealth, flightrec, incident

        if self.diagnostics is not None:
            self.diagnostics.stop()
        if self.prober is not None \
                and devhealth.get_prober() is self.prober:
            devhealth.stop()
        if self.incidents is not None \
                and incident.get_manager() is self.incidents:
            incident.stop()
        if self.watchdog is not None \
                and flightrec.get_watchdog() is self.watchdog:
            flightrec.stop_watchdog()
        if self.runtime_monitor is not None:
            self.runtime_monitor.stop()
        for service in self.cluster_services:
            service.stop()
        self.http.stop()
        # AFTER the transport: in-flight handlers blocked on the
        # coalescer wake with 503 instead of hanging the shutdown
        self.api.close()
        self.holder.close()
        if self.oplog is not None:
            # AFTER holder.close(): fragments are synced and closed, so
            # the shutdown checkpoint can bless everything applied
            self.oplog.close()


def start_server(argv):
    """Parse `server` flags (without the subcommand word), open the
    holder and the oplog, replay the oplog and start the HTTP server;
    returns a Server."""
    from .core import Holder
    from .device import resolve_device
    from .ops import containers
    from .server import API, PilosaHTTPServer
    from .storage import oplog as oplog_mod
    from .utils import devhealth, faultpoints, flightrec, incident, tracing
    from .utils import workload, workpool
    from .utils import stats as stats_mod
    from .utils.logger import StandardLogger

    args = _parser().parse_args(["server", *argv])
    config = _apply_server_flags(load_config(args.config), args)
    device = resolve_device(config.get("device", "cuda"))
    # The collective data plane: every node joins one process group
    # before anything else boots (joining blocks until all have)
    spmd_requested = bool(config.get("spmd"))
    if spmd_requested:
        _spmd_initialize(config)
    # Size the shared host-work pool before anything can submit to it
    # (default min(32, cpu); workers=1 == serial execution).
    if config.get("workers") is not None:
        workpool.configure(int(config["workers"]))
    # module state of ops/containers: applied before the holder opens, so
    # a bad mode fails at start, not at the first query
    containers.configure(config.get("container-repr"))
    # EXPLAIN ANALYZE plan retention + misestimate threshold, and the
    # adaptive engine's mode (exec/plan.py, exec/adaptive.py module
    # state; a bad mode fails at start)
    prs = config.get("plan-ring-size")
    emf = config.get("explain-misestimate-factor")
    cw = config.get("coalesce-window")
    coalesce_window = parse_duration(str(cw)) if cw else 0.0
    if prs is not None or emf is not None or coalesce_window > 0:
        from .exec import plan as plan_mod

        plan_mod.configure(
            ring_size=int(prs) if prs is not None else None,
            misestimate_factor=float(emf) if emf is not None else None,
            coalesce_window=coalesce_window if coalesce_window > 0
            else None)
    amode = config.get("adaptive")
    if amode is not None:
        from .exec import adaptive as adaptive_mod

        adaptive_mod.configure(mode=str(amode))
    # Whole-plan fusion (exec/fusion.py module state): "on" serves an
    # eligible query's every top-level Count as ONE fused dispatch,
    # its program cached by workload fingerprint; "shadow" counts what
    # would fuse without building anything; the default "off" keeps the
    # per-call loop. Applied here so a bad mode fails at start.
    fmode = config.get("fusion")
    fcache = config.get("fusion-cache-size")
    fhits = config.get("fusion-min-hits")
    if fmode is not None or fcache is not None or fhits is not None:
        from .exec import fusion as fusion_mod

        fusion_mod.configure(
            mode=str(fmode) if fmode is not None else None,
            cache_size=int(fcache) if fcache is not None else None,
            min_hits=int(fhits) if fhits is not None else None)
    host, _, port = str(config["bind"]).rpartition(":")
    data_dir = os.path.expanduser(config["data-dir"])

    # Durability: fault points arm from the env BEFORE any fsync/replay
    # code runs (a crash harness must be able to hit boot-time points),
    # and the node-wide fsync policy is set BEFORE fragments open so the
    # very first appended op already honors it.
    faultpoints.configure_from_env()
    storage_cfg = config.get("storage", {}) if isinstance(
        config.get("storage", {}), dict) else {}
    oplog_mod.set_fsync_policy(
        storage_cfg.get("fsync", "never"),
        interval=storage_cfg.get("fsync-interval"))

    holder = Holder(data_dir, max_op_n=config.get("max-op-n")).open()
    oplog = None
    services = []
    try:
        cluster, join_needed = _cluster_from_config(config, args, data_dir,
                                                    services)
        if storage_cfg.get("oplog", True):
            seg_bytes = storage_cfg.get("oplog-segment-bytes")
            oplog = oplog_mod.OpLog(
                os.path.join(data_dir, oplog_mod.OPLOG_DIR),
                segment_max_bytes=int(seg_bytes) if seg_bytes
                else oplog_mod.DEFAULT_SEGMENT_BYTES,
                logger=StandardLogger()).open()
        cw = config.get("coalesce-window")
        lqt = config.get("long-query-time")
        # streaming ingest engine: interval 0 — the default — builds none
        imi = config.get("ingest-merge-interval")
        # admission control: off — the default — builds no controller
        adm_cap = config.get("admission-capacity")
        adm_qd = config.get("admission-queue-depth")
        adm_qt = config.get("admission-queue-timeout")
        api = API(holder, device=device,
                  coalesce_window=parse_duration(str(cw)) if cw else 0.0,
                  coalesce_max_queue=int(config.get("coalesce-max-queue",
                                                    256)),
                  max_writes_per_request=int(
                      config.get("max-writes-per-request", 0)),
                  oplog=oplog,
                  long_query_time=parse_duration(str(lqt)) if lqt else None,
                  ingest_interval=parse_duration(str(imi)) if imi else 0.0,
                  admission=str(config.get("admission", "off")).lower(),
                  admission_capacity=float(adm_cap) if adm_cap else None,
                  admission_queue_depth=int(adm_qd) if adm_qd else None,
                  admission_queue_timeout=parse_duration(str(adm_qt))
                  if adm_qt else None,
                  cluster=cluster,
                  spmd=_spmd_plane(holder, cluster, config)
                  if spmd_requested else None)
        if cluster is not None:  # even single-node: the cluster can grow
            from .server import Client
            from .server.syncer import AntiEntropyMonitor, HolderSyncer
            from .server.translate_sync import TranslateReplicator

            interval = parse_duration(
                config.get("anti-entropy", {}).get("interval", "10m"))
            # stopped in list order: replication and repair before the
            # health monitor they read
            services.insert(0, AntiEntropyMonitor(
                HolderSyncer(holder, cluster, Client), interval).start())
            # BEFORE serving: replica stores must be read-only from the
            # first request, or a keyed import could allocate ids that
            # diverge from the primary's
            services.insert(0, TranslateReplicator(
                holder, cluster, Client).start())
        # Crash recovery BEFORE serving: re-apply acked writes the previous
        # process died holding, so the first query already sees them.
        replayed = api.replay_oplog()
    except BaseException:
        for service in services:
            service.stop()
        holder.close()
        if oplog is not None:
            oplog.close()
        raise
    # Metrics backend + runtime sampler (reference: server.go:419 stats
    # selection; server.go:813 monitorRuntime).
    stats = stats_mod.build_stats(
        getattr(args, "stats", None) or config.get("stats"),
        statsd_host=getattr(args, "statsd_host", None)
        or config.get("statsd-host"))
    runtime_monitor = stats_mod.RuntimeMonitor(
        stats, interval=parse_duration(
            config.get("metric-poll-interval", "10s"))).start()
    # Flight recorder (on by default: a bounded ring) and the stall
    # watchdog (only with a deadline). The SIGTERM dump is installed by
    # cmd_server, after its clean-stop handler, so it chains to it.
    frs = config.get("flight-recorder-size")
    if frs is not None:
        flightrec.configure(int(frs))
    watchdog = None
    wd_deadline = config.get("watchdog-deadline")
    if wd_deadline:
        watchdog = flightrec.configure_watchdog(
            parse_duration(str(wd_deadline)), logger=StandardLogger())
    # Span retention (GET /debug/traces): "memory" keeps a bounded ring;
    # the default nop tracer allocates no spans (profiles work either way)
    if config.get("tracing") == "memory":
        tracing.set_tracer(tracing.InMemoryTracer(
            max_spans=int(config.get("trace-max-spans", 10000))))
    if config.get("metrics-exemplars"):
        stats_mod.configure_exemplars(
            True, registry=stats_mod.registry_of(stats))
    # SLO objectives: error-budget burn over the timing histograms.
    # Accepts a repeated --slo flag (list) or a comma-separated string
    # from the config file; a bad spec fails the boot.
    slo_cfg = config.get("slo")
    if slo_cfg:
        items = [slo_cfg] if isinstance(slo_cfg, str) else slo_cfg
        specs = [spec.strip() for item in items
                 for spec in str(item).split(",") if spec.strip()]
        burn = config.get("slo-burn-threshold")
        workload.configure_slo(
            specs, burn_threshold=float(burn) if burn is not None else None,
            logger=StandardLogger())
    # Incident autopsy: anomaly-triggered postmortem bundles (devhealth
    # DOWN, watchdog stall, SLO burn, deadline storms, SIGTERM). Without
    # --incident-dir every hook site is one module-global check.
    incidents = None
    inc_dir = config.get("incident-dir")
    if inc_dir:
        inc_max = config.get("incident-max")
        incidents = incident.configure(
            str(inc_dir),
            max_incidents=int(inc_max) if inc_max is not None
            else incident.DEFAULT_MAX_INCIDENTS,
            logger=StandardLogger())
        # bundle surfaces that live on instances, not modules
        incidents.register_collector(
            "oplog", lambda: (dict(oplog.summary(), enabled=True)
                              if oplog is not None else {"enabled": False}))
        incidents.register_collector("admission", api.admission_stats)
    # Device-link prober: a canary launch on the executor's device every
    # interval drives /readyz and the query fail-fast gate. Off unless
    # an interval is set: then the module launches nothing.
    prober = None
    probe_interval = config.get("device-probe-interval")
    if probe_interval:
        probe_deadline = config.get("device-probe-deadline")
        prober = devhealth.configure(
            interval=parse_duration(str(probe_interval)),
            deadline=parse_duration(str(probe_deadline))
            if probe_deadline else devhealth.DEFAULT_DEADLINE,
            logger=StandardLogger(), device=device)
    # Diagnostics phone-home: opt-in only, and only with an explicit
    # endpoint (reference: diagnostics.go + server.go:760).
    diagnostics = None
    diag_cfg = config.get("diagnostics", {})
    if isinstance(diag_cfg, dict) and diag_cfg.get("enabled") \
            and diag_cfg.get("endpoint"):
        from .server.diagnostics import Diagnostics

        diagnostics = Diagnostics(
            api, diag_cfg["endpoint"],
            interval=parse_duration(diag_cfg.get("interval", "1h")),
            logger=StandardLogger()).start()
    # TLS + CORS come from the MERGED config only, so `config` output is
    # exactly what runs here (reference: handler.allowed-origins
    # server/config.go:75).
    tls_cfg = config.get("tls", {}) if isinstance(
        config.get("tls", {}), dict) else {}
    origins = config.get("handler", {}).get("allowed-origins", []) \
        if isinstance(config.get("handler", {}), dict) else []
    if isinstance(origins, str):  # scalar TOML value / comma-joined flag
        origins = origins.split(",")
    origins = [o.strip() for o in origins if o.strip()]
    try:
        http = PilosaHTTPServer(
            api, host=host or "127.0.0.1", port=int(port or 10101),
            stats=stats, tls_cert=tls_cfg.get("certificate"),
            tls_key=tls_cfg.get("key"), allowed_origins=origins).start()
    except BaseException:
        if diagnostics is not None:
            diagnostics.stop()
        if prober is not None:
            devhealth.stop()
        if incidents is not None:
            incident.stop()
        if watchdog is not None:
            flightrec.stop_watchdog()
        runtime_monitor.stop()
        for service in services:
            service.stop()
        api.close()
        holder.close()
        if oplog is not None:
            oplog.close()
        raise
    if join_needed:
        _start_join(cluster, "https" if tls_cfg.get("certificate")
                    else "http")
    return Server(holder, api, http, oplog=oplog, replayed=replayed,
                  runtime_monitor=runtime_monitor, watchdog=watchdog,
                  prober=prober, incidents=incidents,
                  diagnostics=diagnostics, cluster_services=services)


def _spmd_initialize(config):
    """Join the collective data plane's process group: this node's rank
    is its place in --cluster-hosts, the group's store is on the first
    host at --spmd-port (default 27121)."""
    from .cluster.spmd import SpmdDataPlane

    if not config.get("cluster-hosts"):
        raise SystemExit("--spmd requires --cluster-hosts")
    norm = [h.strip().split("//", 1)[-1]
            for h in str(config["cluster-hosts"]).split(",") if h.strip()]
    local_ref = str(config.get("node-id") or config["bind"]).split(
        "//", 1)[-1]
    if local_ref not in norm:
        raise SystemExit(
            f"--spmd: node id {local_ref!r} not in --cluster-hosts")
    coord_host = norm[0].rsplit(":", 1)[0]
    SpmdDataPlane.initialize(
        coordinator_address=f"{coord_host}:"
                            f"{int(config.get('spmd-port', 27121))}",
        num_processes=len(norm), process_id=norm.index(local_ref),
        cpu_collectives=config.get("spmd-cpu-collectives"))


def _spmd_plane(holder, cluster, config):
    """The node's collective data plane (None without a cluster), with
    --spmd-serve and --spmd-stream-gap-timeout. It is the process's
    active plane (the incident bundles' `spmd` collector reads it) and
    hangs its stream-occupancy gauges on the process stats client."""
    if cluster is None:
        return None
    from .cluster import spmd as spmd_mod
    from .server import Client
    from .utils.logger import StandardLogger

    sgt = config.get("spmd-stream-gap-timeout")
    plane = spmd_mod.SpmdDataPlane(
        holder, cluster, Client, logger=StandardLogger(),
        serve_mode=str(config.get("spmd-serve", "off")).lower(),
        stream_gap_timeout=parse_duration(str(sgt)) if sgt else None)
    spmd_mod.set_active_plane(plane)
    plane.register_gauges()
    return plane


def _cluster_from_config(config, args, data_dir, services):
    """The node's Cluster (None on a single node) and whether it must
    still register with the coordinator. A static host list
    (`--cluster-hosts`, hosts known up front; reference: gossip seeds
    server/config.go), OR a dynamic join (`--join`): the cluster is read
    from a seed node and this node registers through the coordinator's
    resize flow once it serves (reference: gossip join retry
    gossip/gossip.go:116-140 + nodeJoin cluster.go:1796). The peer
    health monitor it starts is appended to `services`."""
    import time

    hosts = config.get("cluster-hosts")
    join_target = getattr(args, "join", None) or config.get("join")
    if join_target and hosts:
        raise SystemExit("--join and --cluster-hosts are mutually exclusive")
    if not join_target and not hosts:
        return None, False
    from .cluster import Cluster, HealthMonitor, Node
    from .server import Client

    local_id = config.get("node-id") or config["bind"]
    if local_id.startswith("http"):
        local_id = local_id.split("//", 1)[1]
    join_needed = False
    if join_target:
        seed_uri = join_target if join_target.startswith("http") \
            else f"http://{join_target}"
        status = None
        last = None
        for _ in range(30):  # the seed may still be booting
            try:
                status = Client(seed_uri, timeout=5).status()
                break
            except Exception as e:  # noqa: BLE001
                last = e
                time.sleep(1.0)
        if status is None:
            raise SystemExit(
                f"cannot reach join target {join_target}: {last}")
        if any(not isinstance(d.get("uri"), str)
               for d in status.get("nodes", [])):
            raise SystemExit(
                f"join target {join_target} is not clustered "
                "(started without --cluster-hosts)")
        join_host = local_id.rsplit(":", 1)[0]
        if join_host in ("0.0.0.0", "::", "") or ":" not in local_id:
            raise SystemExit(
                "--join registers this node's id as its reachable URI; "
                f"{local_id!r} is not reachable — pass --node-id "
                "host:port with a routable host")
        nodes = [Node.from_json(d) for d in status["nodes"]]
        cluster = Cluster(
            nodes=nodes, local_id=local_id,
            replica_n=int(status.get("replicaN", 1)), path=data_dir)
        # The seed's membership is AUTHORITATIVE: a stale on-disk
        # .topology (e.g. this node was removed while down) must not
        # shadow it, or we'd skip re-registration and serve with a
        # divergent ring. A restarted member appears in the seed's list
        # and skips registration naturally.
        join_needed = cluster.node(local_id) is None
        cluster.save_topology()
    else:
        host_list = [h.strip() for h in hosts.split(",") if h.strip()]
        nodes = []
        for h in host_list:
            uri = h if h.startswith("http") else f"http://{h}"
            nodes.append(Node(id=uri.split("//", 1)[1], uri=uri))
        # node identity: --node-id wins (needed when binding 0.0.0.0),
        # else derived from --bind
        if not any(n.id == local_id for n in nodes):
            raise SystemExit(
                f"node id {local_id!r} not in --cluster-hosts; pass "
                f"--node-id matching one of the listed hosts")
        cluster = Cluster(
            nodes=nodes, local_id=local_id,
            replica_n=int(config.get("replicas", 1)), path=data_dir)
        cluster.load_topology()
        cluster.save_topology()
    services.append(HealthMonitor(cluster, Client).start())
    return cluster, join_needed


def _start_join(cluster, scheme):
    """Register with the coordinator now that this node can serve the
    resize instruction (schema + streamed fragments land over HTTP).
    Retries cover a busy coordinator (a resize already in progress), as
    the reference's join loop does (gossip.go:116-140)."""
    import time

    from .cluster import Node
    from .server import Client

    def join():
        own_uri = f"{scheme}://{cluster.local_id}"
        for attempt in range(60):
            coord = cluster.coordinator
            if coord is not None:
                try:
                    Client(coord.uri).resize_add_node(
                        cluster.local_id, own_uri)
                    print(f"joined cluster via {coord.id}", flush=True)
                    return
                except Exception as e:  # noqa: BLE001
                    if "already in cluster" in str(e):
                        return
            # coordinatorship may have moved since the status snapshot:
            # refresh membership from any live node
            if attempt % 5 == 4:
                for peer in list(cluster.nodes):
                    try:
                        st = Client(peer.uri, timeout=5).status()
                        cluster.nodes = sorted(
                            (Node.from_json(d) for d in st["nodes"]),
                            key=lambda n: n.id)
                        break
                    except Exception:  # noqa: BLE001
                        continue
            time.sleep(2.0)
        print("ERROR: cluster join did not complete after 120s — this "
              "node is serving OUTSIDE the cluster (owns no shards; "
              "writes here are invisible to members). Retry by "
              "restarting with --join.", flush=True)

    threading.Thread(target=join, daemon=True, name="cluster-join").start()


def cmd_server(argv):
    # SIGHUP stays blocked while the server boots: the listener accepts
    # connections before its reload handler is installed below, and a
    # SIGHUP sent in that window would take the default action (or be
    # dropped where the parent ignores SIGHUP) instead of reloading.
    # Blocked, it stays pending and reaches the handler at the unblock.
    # Threads started during the boot inherit the mask, so the signal
    # can only land on the main thread, where Python runs its handlers.
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGHUP})
    try:
        srv = start_server(argv)
    except RuntimeError as e:
        signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGHUP})
        print(f"pilosa_tpu_torch: {e}", file=sys.stderr)
        return 1
    if srv.replayed:
        print(f"oplog: replayed {srv.replayed} record(s) after unclean "
              "shutdown", flush=True)
    extra = f", cluster of {len(srv.cluster.nodes)}" if srv.cluster else ""
    print(f"listening on {srv.uri} (device {srv.api.device}, data: "
          f"{srv.holder.path}{extra})", flush=True)
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    if srv.http.tls_cert:
        # SIGHUP rotates the TLS keypair without a restart (reference:
        # keypairReloader server/tlsconfig.go:68-90); a bad new keypair
        # keeps the old one serving
        def reload_tls(signum, frame):
            try:
                srv.http.reload_tls()
                print("SIGHUP: reloaded TLS certificate and key",
                      flush=True)
            except Exception as e:  # noqa: BLE001 — report, keep serving
                print(f"SIGHUP: keeping old TLS keypair "
                      f"(reload failed: {e})", flush=True)

        signal.signal(signal.SIGHUP, reload_tls)
    signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGHUP})
    # AFTER the clean-stop handler: the crash handler's SIGTERM dump
    # chains to the handler it finds, so a SIGTERM dumps the flight
    # recorder and still stops cleanly (the oplog's shutdown checkpoint)
    from .utils import flightrec
    from .utils.logger import StandardLogger

    flightrec.install_crash_handler(logger=StandardLogger())
    # A process-directed signal may land on any thread that does not
    # block it, and one landing on another thread does not wake a main
    # thread blocked in an untimed wait: poll, so the main thread runs
    # its handler within a second (a cluster node has many threads).
    while not done.wait(1.0):
        pass
    srv.stop()
    return 0


# -- tools --------------------------------------------------------------------


def cmd_import(args):
    """CSV bulk import via the HTTP API (reference: ctl/import.go)."""
    import csv as csv_mod

    from .server import Client

    client = Client(args.host)
    if args.create:
        try:
            client.create_index(args.index)
        except Exception:
            pass
        try:
            options = {}
            if args.field_type == "int":
                options = {"type": "int", "min": args.min, "max": args.max}
            elif args.field_type == "time":
                options = {"type": "time", "timeQuantum": args.time_quantum}
            client.create_field(args.index, args.field, options)
        except Exception:
            pass

    # keyed imports: detect row/column keys from the live schema like the
    # reference (ctl/import.go useRowKeys/useColumnKeys from field/index
    # options). A FAILED schema fetch aborts loudly — guessing "unkeyed"
    # could import numeric-looking keys as raw ids onto wrong columns.
    use_row_keys = use_col_keys = False
    try:
        schema = client.schema()
    except Exception as e:
        raise SystemExit(f"import: cannot fetch schema from {args.host}: {e}")
    for idx_desc in schema.get("indexes", []):
        if idx_desc["name"] != args.index:
            continue
        use_col_keys = bool(
            idx_desc.get("options", {}).get("keys", False))
        for f_desc in idx_desc.get("fields", []):
            if f_desc["name"] == args.field:
                use_row_keys = bool(
                    f_desc.get("options", {}).get("keys", False))

    rows, cols, values, stamps = [], [], [], []
    total = 0
    source = open(args.file) if args.file != "-" else sys.stdin
    try:
        reader = csv_mod.reader(source)
        for rnum, record in enumerate(reader, 1):
            if not record:
                continue
            try:
                if args.field_type == "int":
                    cols.append(record[0] if use_col_keys
                                else int(record[0]))
                    values.append(int(record[1]))
                else:
                    rows.append(record[0] if use_row_keys
                                else int(record[0]))
                    cols.append(record[1] if use_col_keys
                                else int(record[1]))
                    # optional 3rd column: timestamp — TIME fields only
                    # (reference format "2006-01-02T15:04",
                    # ctl/import.go:234); other field types ignore extra
                    # columns
                    stamps.append(
                        record[2] if args.field_type == "time"
                        and len(record) > 2 and record[2] else None)
            except (ValueError, IndexError) as e:
                raise SystemExit(
                    f"import: invalid record on line {rnum}: "
                    f"{record!r} ({e})")
            if len(cols) >= args.batch_size:
                total += _flush_import(client, args, rows, cols, values,
                                       stamps, use_row_keys, use_col_keys)
                rows, cols, values, stamps = [], [], [], []
        if cols:
            total += _flush_import(client, args, rows, cols, values,
                                   stamps, use_row_keys, use_col_keys)
    finally:
        if source is not sys.stdin:
            source.close()
    print(f"imported: {total} changed bits")
    return 0


def _flush_import(client, args, rows, cols, values, stamps,
                  use_row_keys, use_col_keys):
    # Client treats None key lists as absent, so the keys-vs-ids split is
    # one conditional per axis
    column_keys = cols if use_col_keys else None
    if args.field_type == "int":
        out = client.import_values(args.index, args.field, cols, values,
                                   column_keys=column_keys)
    else:
        timestamps = stamps if any(s is not None for s in stamps) else None
        out = client.import_bits(
            args.index, args.field, rows, cols, timestamps=timestamps,
            row_keys=rows if use_row_keys else None,
            column_keys=column_keys)
    return out.get("changed", 0) if isinstance(out, dict) else 0


def cmd_backup(args):
    """Archive an index (schema + every fragment's roaring blob) from a
    live server into a tar file (reference: fragment.WriteTo tar archives
    fragment.go:2436-2607 + ctl backup tooling)."""
    import io
    import tarfile

    from .server import Client

    def make_client(url):
        return Client(url, tls_skip_verify=args.tls_skip_verify,
                      ca_cert=args.tls_ca)

    client = make_client(args.host)
    schema = client.schema()
    indexes = [i for i in schema.get("indexes", [])
               if args.index is None or i["name"] == args.index]
    if args.index is not None and not indexes:
        raise SystemExit(f"index not found: {args.index}")

    # Internal fragment endpoints are node-local; on a cluster, walk every
    # node so shards held only by peers are captured too (a single-node
    # backup of a cluster would otherwise be silently partial).
    clients = [client]
    for node in client.nodes():
        uri = node.get("uri")
        if uri and uri.rstrip("/") != client.base_url:
            clients.append(make_client(uri))

    def add(tar, name, data):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))

    # Write to a temp name and publish only on success so a refused or
    # crashed backup never leaves a plausible-looking partial archive at
    # --output (same temp+rename discipline as fragment snapshots).
    tmp_out = args.output + ".partial"
    n_frags = 0
    unreachable = []
    with tarfile.open(tmp_out, "w") as tar:
        add(tar, "schema.json",
            json.dumps({"indexes": indexes}).encode())
        for idx in indexes:
            iname = idx["name"]
            seen = set()
            for c in clients:
                # a node can fail at ANY of the three fetches; every
                # failure routes through the same unreachable gate
                try:
                    shards = c.index_shards(iname).get("shards", [])
                    for shard in shards:
                        frags = c.shard_fragments(
                            iname, shard).get("fragments", [])
                        for frag in frags:
                            name = (f"{iname}/{frag['field']}"
                                    f"/{frag['view']}/{shard}")
                            if name in seen:
                                continue
                            data = c.fragment_data(
                                iname, frag["field"], frag["view"], shard)
                            seen.add(name)
                            add(tar, name, data)
                            n_frags += 1
                except Exception as e:
                    unreachable.append(f"{c.base_url} ({e})")
    if unreachable:
        # An unreachable node may hold shards no replica covers; there is
        # no way to verify coverage without it, so don't pretend the
        # archive is complete (reference behavior: backups are node-exact).
        print(f"warning: node(s) unreachable during backup: "
              f"{sorted(set(unreachable))}; archive may be missing their "
              f"exclusively-held shards", file=sys.stderr)
        if not args.allow_partial:
            os.unlink(tmp_out)
            raise SystemExit(
                "refusing to write a possibly-partial backup "
                "(pass --allow-partial to accept)")
    os.replace(tmp_out, args.output)
    print(f"backed up {len(indexes)} index(es), {n_frags} fragment(s) "
          f"to {args.output}")
    return 0


def cmd_restore(args):
    """Restore a backup tar into a live server: schema first, then each
    fragment via the import-roaring fast path (reference: fragment.ReadFrom
    + api.ImportRoaring api.go:368)."""
    import tarfile

    from .server import Client

    client = Client(args.host, tls_skip_verify=args.tls_skip_verify,
                    ca_cert=args.tls_ca)
    n_frags = 0
    with tarfile.open(args.input) as tar:
        schema_member = tar.getmember("schema.json")
        schema = json.loads(tar.extractfile(schema_member).read())
        client._request("POST", "/schema", json.dumps(schema).encode())
        for member in tar.getmembers():
            if member.name == "schema.json" or not member.isfile():
                continue
            index, field, view, shard = member.name.split("/")
            client.import_roaring(
                index, field, int(shard), tar.extractfile(member).read(),
                view=view)
            n_frags += 1
    print(f"restored {n_frags} fragment(s) from {args.input}")
    return 0


def cmd_export(args):
    """(reference: ctl/export.go)"""
    from .server import Client

    client = Client(args.host)
    shards = range(args.shards) if args.shards else None
    if shards is None:
        status = client._request("GET", "/internal/shards/max")
        max_shard = status.get("standard", {}).get(args.index, 0)
        shards = range(max_shard + 1)
    for shard in shards:
        sys.stdout.write(client.export_csv(args.index, args.field, shard))
    return 0


def cmd_inspect(args):
    """Dump fragment bit counts from a data file (reference:
    ctl/inspect.go)."""
    from .roaring import deserialize

    with open(args.path, "rb") as f:
        data = f.read()
    bitmap, flags, ops = deserialize(data)
    print(f"file: {args.path}")
    print(f"flags: {flags}  ops-replayed: {ops}")
    print(f"containers: {len(bitmap.keys())}  bits: {bitmap.count()}")
    from .shardwidth import CONTAINERS_PER_SHARD

    rows = {}
    for key in bitmap.keys():
        row = key // CONTAINERS_PER_SHARD
        rows[row] = rows.get(row, 0) + bitmap.containers[key].n
    for row in sorted(rows):
        print(f"  row {row}: {rows[row]} bits")
    return 0


def cmd_check(args):
    """Consistency-check fragment files (reference: ctl/check.go)."""
    from .roaring import FormatError, deserialize

    failed = 0
    for path in args.paths:
        try:
            with open(path, "rb") as f:
                bitmap, _, _ = deserialize(f.read())
            for key in bitmap.keys():
                c = bitmap.containers[key]
                if c.n != c._count():
                    raise FormatError(
                        f"container {key}: cardinality mismatch")
            print(f"{path}: ok")
        except Exception as e:
            failed += 1
            print(f"{path}: FAILED — {e}")
    return 1 if failed else 0


def cmd_config(args):
    """Print the EFFECTIVE merged configuration — file < env < flags — as
    TOML (reference: cmd/root.go:71-78 registers ctl/config.go, whose Run
    marshals the fully-populated server.Config that viper merged from all
    three sources). `generate-config` prints defaults; this prints what
    the server would actually run with."""
    config = _apply_server_flags(load_config(args.config), args)
    from .shardwidth import EXPONENT

    config.setdefault("shard-width-exponent", EXPONENT)
    scalars = {k: v for k, v in config.items() if not isinstance(v, dict)}
    tables = {k: v for k, v in config.items() if isinstance(v, dict)}
    for key in sorted(scalars):
        print(f"{key} = {_toml_value(scalars[key])}")
    for name in sorted(tables):
        print()
        print(f"[{name}]")
        for key in sorted(tables[name]):
            print(f"{key} = {_toml_value(tables[name][key])}")
    return 0


def cmd_holder(args):
    """Open the data directory, load everything, shut down (reference:
    cmd/server.go:33-57 newHolderCmd — 'only useful for diagnostic use':
    proves the on-disk state loads cleanly and shows what is in it)."""
    from .core import Holder

    config = _apply_server_flags(load_config(args.config), args)
    data_dir = os.path.expanduser(config["data-dir"])
    if not os.path.isdir(data_dir):
        # a diagnostic must not create (and then bless) a mistyped path
        print(f"holder: data directory does not exist: {data_dir}",
              file=sys.stderr)
        return 1
    holder = Holder(data_dir).open()
    try:
        n_frags = sum(1 for _ in holder._all_fragments())
        print(f"holder loaded: {data_dir}")
        print(f"indexes: {len(holder.indexes)}  "
              f"fields: {sum(len(i.fields) for i in holder.indexes.values())}  "
              f"fragments: {n_frags}")
        for idx in sorted(holder.indexes.values(), key=lambda i: i.name):
            fields = ", ".join(
                f"{f.name}({f.type})"
                for f in sorted(idx.fields.values(), key=lambda f: f.name))
            print(f"  {idx.name}: {fields}")
    finally:
        holder.close()
    return 0


def cmd_generate_config(args):
    """(reference: ctl/generate_config.go) Print default TOML config."""
    print('bind = "127.0.0.1:10101"')
    print(f'data-dir = "{DEFAULT_CONFIG["data-dir"]}"')
    print("max-op-n = 10000")
    print()
    print("[cluster]")
    print("coordinator = true")
    print("nodes = []")
    print()
    print('[anti-entropy]')
    print('interval = "10m"')
    return 0


# -- parsers ------------------------------------------------------------------


def _server_flags(p):
    """The server's flags; `config` takes the same ones, so it prints
    what `server` would run with."""
    p.add_argument("--config", default=None,
                   help="TOML config file (flags and PILOSA_TPU_BIND / "
                        "PILOSA_TPU_DATA_DIR override it)")
    p.add_argument("--bind", default=None,
                   help="host:port to listen on (port 0 = ephemeral; "
                        "default 127.0.0.1:10101)")
    p.add_argument("--data-dir", default=None,
                   help="data directory (default ~/.pilosa_tpu_torch)")
    p.add_argument("--device", default=None,
                   help="torch device for the query path (cuda, the "
                        "default, or cpu)")
    p.add_argument("--cluster-hosts", default=None,
                   help="comma-separated host:port list of ALL cluster "
                        "nodes (static bootstrap); omit for single-node")
    p.add_argument("--node-id", default=None,
                   help="this node's id (defaults to host:port of --bind)")
    p.add_argument("--join", default=None,
                   help="host:port of ANY existing cluster node: discover "
                        "the cluster from it and join dynamically via the "
                        "coordinator's resize flow (mutually exclusive "
                        "with --cluster-hosts)")
    p.add_argument("--replicas", type=int, default=None,
                   help="replication factor (default 1)")
    p.add_argument("--spmd", action="store_true", default=False,
                   help="collective data plane: every --cluster-hosts "
                        "node joins one torch.distributed process group "
                        "and coverable Count/Sum/Min/Max/TopN/GroupBy "
                        "merges ride its collectives instead of HTTP")
    p.add_argument("--spmd-port", type=int, default=None,
                   help="port of the process group's store on the first "
                        "--cluster-hosts host (default 27121)")
    p.add_argument("--spmd-serve", default=None,
                   choices=("off", "on", "shadow"),
                   help="mesh-resident serving for --spmd: off (default) "
                        "gathers every step's leaves from the host; on "
                        "keeps each rank's leaf blocks on its device, "
                        "announces steps over the step stream and runs "
                        "coalesced and fused Count batches as one step; "
                        "shadow serves as off while probing the mesh "
                        "cache for divergence")
    p.add_argument("--spmd-cpu-collectives", default=None,
                   choices=["none", "gloo"],
                   help="collectives backend for --spmd; the group is "
                        "gloo either way (its collectives reduce host "
                        "tensors)")
    p.add_argument("--spmd-stream-gap-timeout", default=None,
                   help="how long a peer's step-stream runner waits on a "
                        "sequence gap before resyncing past it (duration, "
                        "default 30s); the gap's ONSET fires the "
                        "spmd.stream_gap event and a collective_stall "
                        "incident bundle at once")
    p.add_argument("--container-repr", default=None,
                   choices=["auto", "dense", "sparse", "rle"],
                   help="leaf container representation: auto (default, or "
                        "PILOSA_TPU_CONTAINER_REPR) picks dense/block-sparse/"
                        "run-length per fragment by measured density; dense "
                        "forces plain planes; sparse/rle force one "
                        "compressed form where eligible")
    p.add_argument("--coalesce-window", default=None,
                   help="query coalescer window (e.g. 1ms): concurrent "
                        "batchable queries arriving within it fuse into "
                        "batched launches (default 0 = off: every query "
                        "takes the per-query path)")
    p.add_argument("--coalesce-max-queue", type=int, default=None,
                   help="coalesce queue cap: past it, queries get 503 + "
                        "Retry-After instead of an unbounded wait "
                        "(default 256)")
    p.add_argument("--ingest-merge-interval", default=None,
                   help="streaming ingest merge interval (e.g. 250ms): "
                        "import deltas buffer host-side (still "
                        "oplog-durable at ack) and fold into the resident "
                        "device stacks in one in-place merge per "
                        "interval; reads serve the pre-merge stacks "
                        "meanwhile (default 0 = off: reads repair their "
                        "stacks)")
    p.add_argument("--adaptive", default=None,
                   choices=["off", "on", "shadow"],
                   help="adaptive execution engine: on prices "
                        "stacked-vs-per-shard, the GroupBy K4 tile, and "
                        "cache eviction through the calibrated cost model "
                        "+ fragment heat; shadow computes and logs "
                        "decisions without acting; off (default) keeps "
                        "the static paths")
    p.add_argument("--fusion", default=None,
                   choices=["off", "on", "shadow"],
                   help="whole-plan fusion: on serves an eligible "
                        "query's every top-level Count as ONE fused "
                        "dispatch (K1's multi-tree entry for the dense "
                        "trees), its program cached by workload "
                        "fingerprint (a cold fingerprint never builds "
                        "one); shadow counts what would fuse without "
                        "building; off (default) keeps the per-call loop")
    p.add_argument("--fusion-cache-size", type=int, default=None,
                   help="bounded LRU of fused programs per process "
                        "(default 64); eviction drops the program table, "
                        "so re-entry rebuilds it")
    p.add_argument("--fusion-min-hits", type=int, default=None,
                   help="completed queries a workload fingerprint needs "
                        "before its first fused program build "
                        "(default 2); raise it when /debug/fusion shows "
                        "builds outnumbering cache hits")
    p.add_argument("--admission", default=None,
                   choices=["off", "on"],
                   help="cost-aware admission control + degradation "
                        "ladder: classifies queries (X-Query-Class / "
                        "PQL shape), prices them through the EXPLAIN "
                        "cost model, debits per-class token buckets, "
                        "queues bounded past capacity, and degrades "
                        "NORMAL->SHED_BATCH->STALE_OK->LIFEBOAT on SLO "
                        "burn / device health; off (default) admits "
                        "everything")
    p.add_argument("--admission-capacity", type=float, default=None,
                   help="admission token refill rate in device-ms per "
                        "second (default 1000 = one device's worth); "
                        "split interactive/batch/internal 60/30/10")
    p.add_argument("--admission-queue-depth", type=int, default=None,
                   help="bounded admission queue per class: past it, "
                        "queries get 503 + Retry-After (default 64)")
    p.add_argument("--admission-queue-timeout", default=None,
                   help="max time a query waits for admission tokens "
                        "before 503 (e.g. 5s; default 5s)")
    p.add_argument("--plan-ring-size", type=int, default=None,
                   help="retained misestimated EXPLAIN ANALYZE plans "
                        "(GET /debug/plans; default 128)")
    p.add_argument("--explain-misestimate-factor", type=float,
                   default=None,
                   help="flag a plan node when actual cost deviates from "
                        "the estimate by more than this factor in either "
                        "direction (default 3.0)")
    p.add_argument("--max-writes-per-request", type=int, default=None,
                   help="reject queries with more than this many write "
                        "calls (reference: max-writes-per-request); "
                        "<=0 disables")
    p.add_argument("--fsync", default=None,
                   choices=["always", "interval", "never"],
                   help="durability fsync policy for the write-ahead "
                        "oplog AND fragment WALs ([storage] fsync; "
                        "default never): always = fsync before every "
                        "ack, interval = background fsync every ~50ms, "
                        "never = OS flush only")
    p.add_argument("--no-oplog", action="store_true", default=False,
                   help="disable the durable write-ahead oplog "
                        "([storage] oplog = false): acked writes held "
                        "only in memory are lost on crash")
    p.add_argument("--oplog-segment-bytes", type=int, default=None,
                   help="oplog segment rotation size in bytes "
                        "([storage] oplog-segment-bytes; default 64MiB); "
                        "rotation also triggers a checkpoint")
    p.add_argument("--long-query-time", default=None,
                   help="log queries slower than this duration "
                        "(e.g. 500ms, 2s); disabled when unset")
    p.add_argument("--stats", default=None,
                   choices=["local", "statsd", "none"],
                   help="metrics backend (default local registry; statsd "
                        "also emits UDP datagrams)")
    p.add_argument("--tracing", default=None,
                   choices=["none", "memory"],
                   help="span retention: memory keeps a bounded ring of "
                        "finished spans served at /debug/traces "
                        "(default none: nop tracer, zero overhead)")
    p.add_argument("--statsd-host", default=None,
                   help="statsd host:port (default 127.0.0.1:8125)")
    p.add_argument("--workers", type=int, default=None,
                   help="host-side worker pool size for per-shard fan-out "
                        "(default min(32, cpu), env PILOSA_TPU_WORKERS; "
                        "1 = serial execution)")
    p.add_argument("--flight-recorder-size", type=int, default=None,
                   help="flight-recorder ring capacity in events "
                        "(default 2048; 0 disables recording)")
    p.add_argument("--watchdog-deadline", default=None,
                   help="stall watchdog deadline (e.g. 30s, 2m): dump "
                        "stacks + recorder tail when a dispatch or query "
                        "runs past it; disabled when unset")
    p.add_argument("--metrics-exemplars", action="store_true",
                   default=None,
                   help="keep one recent trace id per timing-histogram "
                        "bucket and expose it in OpenMetrics exemplar "
                        "syntax on /metrics and in /debug/slo")
    p.add_argument("--tls-certificate", default=None,
                   help="PEM certificate file; serves HTTPS when set "
                        "(SIGHUP reloads it and the key)")
    p.add_argument("--tls-key", default=None, help="PEM key file")
    p.add_argument("--allowed-origins", default=None,
                   help="comma-separated CORS origins browsers may query "
                        "from ('*' allows all); no CORS headers when unset")
    p.add_argument("--device-probe-interval", default=None,
                   help="device-link canary probe interval (e.g. 1s, "
                        "500ms): a canary launch on the query device "
                        "drives the LIVE/DEGRADED/DOWN readiness state at "
                        "/readyz and /debug/device; disabled when unset")
    p.add_argument("--device-probe-deadline", default=None,
                   help="per-canary deadline (e.g. 5s) before a probe "
                        "counts as a device-link failure (default 5s)")
    p.add_argument("--incident-dir", default=None,
                   help="directory for anomaly-triggered postmortem "
                        "bundles (flightrec dump, thread stacks, /debug "
                        "snapshots) written on devhealth DOWN, watchdog "
                        "stall, SLO burn, deadline storms, and SIGTERM; "
                        "served at /debug/incidents; disabled when unset")
    p.add_argument("--incident-max", type=int, default=None,
                   help="retained incident bundles before the oldest is "
                        "deleted (default 16)")
    p.add_argument("--slo", action="append", default=None,
                   help="latency objective as name=threshold@quantile "
                        "(e.g. query=50ms@p99); repeatable. Tracked as "
                        "multi-window error-budget burn at /debug/slo "
                        "and slo_burn_rate gauges")
    p.add_argument("--slo-burn-threshold", type=float, default=None,
                   help="burn-rate multiple that must be exceeded in "
                        "BOTH the fast and slow windows before "
                        "slo.burn_alert fires (default 6.0)")


def _parser():
    parser = argparse.ArgumentParser(
        prog="pilosa_tpu_torch",
        description="the bitmap index on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("server", help="serve the HTTP API")
    _server_flags(p)

    p = sub.add_parser("import", help="bulk-import CSV data")
    p.add_argument("--host", default="http://127.0.0.1:10101")
    p.add_argument("--index", required=True)
    p.add_argument("--field", required=True)
    p.add_argument("--create", action="store_true",
                   help="create index/field if missing")
    p.add_argument("--field-type", default="set",
                   choices=["set", "int", "time"])
    p.add_argument("--min", type=int, default=0)
    p.add_argument("--max", type=int, default=(1 << 31) - 1)
    p.add_argument("--time-quantum", default="YMD")
    p.add_argument("--batch-size", type=int, default=100_000)
    p.add_argument("file", help="CSV path or - for stdin")
    p.set_defaults(fn=cmd_import)

    def add_tls_flags(p):
        p.add_argument("--tls-skip-verify", action="store_true",
                       help="accept any server certificate")
        p.add_argument("--tls-ca", default=None,
                       help="PEM CA bundle for https servers")

    p = sub.add_parser("backup", help="archive index data from a server")
    p.add_argument("--host", default="http://127.0.0.1:10101")
    p.add_argument("--index", default=None,
                   help="index to back up (default: all)")
    p.add_argument("--output", required=True, help="tar file to write")
    p.add_argument("--allow-partial", action="store_true",
                   help="write the archive even when some cluster nodes "
                        "are unreachable")
    add_tls_flags(p)
    p.set_defaults(fn=cmd_backup)

    p = sub.add_parser("restore", help="restore a backup tar into a server")
    p.add_argument("--host", default="http://127.0.0.1:10101")
    p.add_argument("--input", required=True, help="tar file to read")
    add_tls_flags(p)
    p.set_defaults(fn=cmd_restore)

    p = sub.add_parser("export", help="export a field as CSV")
    p.add_argument("--host", default="http://127.0.0.1:10101")
    p.add_argument("--index", required=True)
    p.add_argument("--field", required=True)
    p.add_argument("--shards", type=int, default=None)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("inspect", help="inspect a fragment data file")
    p.add_argument("path")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("check", help="consistency-check fragment files")
    p.add_argument("paths", nargs="+")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("generate-config", help="print default config TOML")
    p.set_defaults(fn=cmd_generate_config)

    p = sub.add_parser(
        "holder", help="open the data directory, load it, shut down "
                       "(diagnostic)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--config", default=None)
    p.set_defaults(fn=cmd_holder)

    p = sub.add_parser(
        "config", help="print the effective merged config as TOML "
                       "(file < env < flags)")
    _server_flags(p)
    p.set_defaults(fn=cmd_config)
    return parser


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.command == "server":
        return cmd_server(argv[1:])
    return args.fn(args)
