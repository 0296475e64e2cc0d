"""Command-line frontend (port of ``flink_tpu/cli.py``).

reference: flink-clients CliFrontend (bin/flink run / list / info / cancel /
savepoint / stop) — the operational surface an operator scripts against.
Re-design: `run` executes a Python pipeline script with -D dynamic
properties and restore flags injected through the environment (the
reference injects dynamic properties into the client Configuration the
same way); cluster actions talk to the MiniCluster REST API.

    python3 -m flink_tpu_torch.cli run pipeline.py -D execution.device=cpu
    python3 -m flink_tpu_torch.cli run pipeline.py --restore /ckpts/job
    python3 -m flink_tpu_torch.cli list            --rest 127.0.0.1:8081
    python3 -m flink_tpu_torch.cli info   <job-id> --rest ...
    python3 -m flink_tpu_torch.cli cancel <job-id> --rest ...
    python3 -m flink_tpu_torch.cli savepoint <job-id> /path [--stop] ...
    python3 -m flink_tpu_torch.cli jobmanager --port 6123 --rest-port 8081
    python3 -m flink_tpu_torch.cli taskexecutor --jobmanager host:6123
    python3 -m flink_tpu_torch.cli deploy kubernetes <id> --dry-run
    python3 -m flink_tpu_torch.cli inspect /path/to/snapshot

The device comes from the configuration: a job runs on the card unless
``-D execution.device=cpu`` (or its own configuration) says otherwise;
the JobManager and TaskExecutor processes select no platform. ``query``
prints a running job's state for one key through the REST state route.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.error
import urllib.parse
import urllib.request

#: env vars `run` uses to hand flags to StreamExecutionEnvironment
DYNAMIC_PROPS_ENV = "FLINK_TPU_DYNAMIC_PROPS"
RESTORE_FROM_ENV = "FLINK_TPU_RESTORE_FROM"
RESTORE_MODE_ENV = "FLINK_TPU_RESTORE_MODE"


def _http(url: str, body: dict = None):
    """One REST call; a server error raises ``RuntimeError`` carrying the
    server's message."""
    if body is None:
        req = urllib.request.Request(url)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        detail = e.read().decode("utf-8", "replace")
        raise RuntimeError(f"{url}: HTTP {e.code} {detail}") from e


def _base(args) -> str:
    rest = args.rest
    if "://" not in rest:
        rest = "http://" + rest
    return rest.rstrip("/")


def _parse_defines(defines) -> dict:
    """-D key=value pairs; malformed input exits 2 with a message (one
    parser for every subcommand)."""
    props = {}
    for d in defines or []:
        if "=" not in d:
            print(f"-D expects key=value, got {d!r}", file=sys.stderr)
            raise SystemExit(2)
        k, v = d.split("=", 1)
        props[k] = v
    return props


def cmd_run(args) -> int:
    props = _parse_defines(args.define)
    overrides = {}
    if props:
        overrides[DYNAMIC_PROPS_ENV] = json.dumps(props)
    if args.restore:
        overrides[RESTORE_FROM_ENV] = args.restore
        overrides[RESTORE_MODE_ENV] = args.restore_mode
    import runpy

    prior = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    argv_prior = sys.argv
    sys.argv = [args.script] + (args.script_args or [])
    try:
        runpy.run_path(args.script, run_name="__main__")
    finally:
        sys.argv = argv_prior
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return 0


def cmd_list(args) -> int:
    jobs = _http(f"{_base(args)}/jobs")["jobs"]
    for j in jobs:
        print(f"{j['job_id']}  {j['status']:<10}  attempt={j.get('attempt')}"
              f"  {j.get('name', '')}")
    if not jobs:
        print("(no jobs)")
    return 0


def cmd_info(args) -> int:
    print(json.dumps(_http(f"{_base(args)}/jobs/{args.job_id}"), indent=2))
    return 0


def cmd_cancel(args) -> int:
    out = _http(f"{_base(args)}/jobs/{args.job_id}/cancel", body={})
    print(json.dumps(out))
    return 0


def cmd_savepoint(args) -> int:
    out = _http(f"{_base(args)}/jobs/{args.job_id}/savepoints",
                body={"target": args.target, "stop": args.stop,
                      "drain": args.drain})
    print(json.dumps(out))
    return 0


def cmd_query(args) -> int:
    q = {"key": args.key, "key-type": args.key_type}
    if args.namespace is not None:
        q["namespace"] = str(args.namespace)
    op = urllib.parse.quote(args.operator, safe="")
    url = (f"{_base(args)}/jobs/{args.job_id}/state/{op}"
           f"?{urllib.parse.urlencode(q)}")
    print(json.dumps(_http(url), indent=2))
    return 0


def cmd_inspect(args) -> int:
    from flink_tpu_torch.state_processor import SavepointReader

    reader = SavepointReader.load(args.path)
    print(f"snapshot: {reader.path}")
    print(f"job: {reader.job_name}  checkpoint_id: {reader.checkpoint_id}")
    for uid in reader.operators():
        state = reader.read_state(uid)
        if "source" in state:
            print(f"  {uid}: source position {state['source']}")
        elif reader.has_keyed_state(uid):
            batch = reader.read_keyed_state(uid)
            print(f"  {uid}: keyed state, {len(batch)} rows, "
                  f"columns {sorted(batch.columns)}")
        else:
            print(f"  {uid}: host state, keys {sorted(state)}")
    return 0


def _props_config(defines):
    from flink_tpu_torch.core.config import Configuration

    return Configuration(_parse_defines(defines))


def cmd_jobmanager(args) -> int:
    """Standalone JobManager process (reference:
    StandaloneSessionClusterEntrypoint / jobmanager.sh)."""
    from flink_tpu_torch.cluster.standalone import run_jobmanager

    cfg = _props_config(args.define)
    # explicit flags win; -D wins over the built-in defaults
    if args.port is not None:
        cfg.set("rpc.port", args.port)
    elif cfg.get_raw("rpc.port") is None:
        cfg.set("rpc.port", 6123)
    if args.rest_port is not None:
        cfg.set("rest.port", args.rest_port)
    elif cfg.get_raw("rest.port") is None:
        cfg.set("rest.port", 8081)
    run_jobmanager(cfg)
    return 0


def cmd_taskexecutor(args) -> int:
    """Standalone TaskExecutor process (reference: TaskManagerRunner /
    taskmanager.sh)."""
    from flink_tpu_torch.cluster.standalone import TaskExecutorRunner

    cfg = _props_config(args.define)
    if args.slots is not None:
        cfg.set("taskmanager.numberOfTaskSlots", args.slots)
    runner = TaskExecutorRunner(args.jobmanager, cfg)
    print(f"taskexecutor {runner.executor_id} rpc on {runner.address}, "
          f"registering with {args.jobmanager}, device {_device_line()}",
          flush=True)
    runner.run_forever()
    return 0


def _device_line() -> str:
    """This process's card (each job's ``execution.device`` decides
    whether it runs there)."""
    import torch

    if torch.cuda.is_available():
        return (f"cuda ({torch.cuda.get_device_name(0)}, "
                f"{torch.cuda.device_count()} visible)")
    return "cpu (no CUDA card)"


def cmd_deploy(args) -> int:
    """Kubernetes deployment driver (reference:
    KubernetesClusterDescriptor / KubernetesResourceManagerDriver)."""
    import json as _json

    from flink_tpu_torch.cluster.deployment import (
        KubectlClient,
        KubernetesDeployment,
    )

    if args.action == "scale" and args.task_executors is None:
        print("deploy scale requires an explicit --task-executors count "
              "(refusing to silently scale to a default)",
              file=sys.stderr)
        return 2
    dep = KubernetesDeployment(
        args.cluster_id, config=_props_config(args.define),
        image=args.image,
        task_executors=(args.task_executors
                        if args.task_executors is not None else 2),
        slots_per_executor=args.slots,
        gpus_per_executor=args.gpus_per_executor,
        gpu_product=args.gpu_product,
        client=KubectlClient(namespace=args.namespace))
    if args.action == "kubernetes":
        if args.dry_run:
            for m in dep.manifests():
                print(_json.dumps(m, indent=2))
            return 0
        dep.deploy()
        print(f"deployed {dep.jm_name} + {dep.te_name} "
              f"(x{args.task_executors})")
    elif args.action == "scale":
        dep.scale_task_executors(args.task_executors)
        print(f"scaled {dep.te_name} to {args.task_executors}")
    else:
        dep.teardown()
        print(f"tore down cluster {args.cluster_id}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flink_tpu_torch.cli",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="command", required=True)

    pj = sub.add_parser("jobmanager",
                        help="run a standalone JobManager process")
    pj.add_argument("--port", type=int, default=None,
                    help="control-plane RPC port (default 6123; "
                    "-D rpc.port=... also works)")
    pj.add_argument("--rest-port", type=int, default=None,
                    help="REST port (default 8081)")
    pj.add_argument("-D", dest="define", action="append", metavar="K=V")
    pj.set_defaults(fn=cmd_jobmanager)

    pt = sub.add_parser("taskexecutor",
                        help="run a standalone TaskExecutor process")
    pt.add_argument("--jobmanager", default="127.0.0.1:6123",
                    help="JobManager rpc address host:port")
    pt.add_argument("--slots", type=int, default=None)
    pt.add_argument("-D", dest="define", action="append", metavar="K=V")
    pt.set_defaults(fn=cmd_taskexecutor)

    pk = sub.add_parser(
        "deploy", help="deploy / scale / tear down a Kubernetes cluster "
        "(reference: flink-kubernetes session deployment)")
    pk.add_argument("action", choices=["kubernetes", "scale", "teardown"])
    pk.add_argument("cluster_id")
    pk.add_argument("--image", default="flink-tpu-torch:latest")
    pk.add_argument("--task-executors", type=int, default=None,
                    help="worker replica count (default 2 for deploy; "
                    "REQUIRED for scale)")
    pk.add_argument("--slots", type=int, default=1)
    pk.add_argument("--gpus-per-executor", type=int, default=0,
                    help="nvidia.com/gpu devices each worker pod requests")
    pk.add_argument("--gpu-product", default="NVIDIA-H100-80GB-HBM3",
                    help="the nvidia.com/gpu.product node label workers "
                    "are pinned to")
    pk.add_argument("--namespace", default="default")
    pk.add_argument("--dry-run", action="store_true",
                    help="print the manifests instead of applying them")
    pk.add_argument("-D", dest="define", action="append", metavar="K=V")
    pk.set_defaults(fn=cmd_deploy)

    pr = sub.add_parser("run", help="run a pipeline script")
    pr.add_argument("script")
    pr.add_argument("script_args", nargs="*")
    pr.add_argument("-D", dest="define", action="append", metavar="K=V",
                    help="dynamic config property (repeatable)")
    pr.add_argument("--restore", help="checkpoint root / savepoint to "
                    "restore from")
    pr.add_argument("--restore-mode", default="no-claim",
                    choices=["no-claim", "claim"])
    pr.set_defaults(fn=cmd_run)

    for name, fn in (("list", cmd_list),):
        ps = sub.add_parser(name, help="list cluster jobs")
        ps.add_argument("--rest", default="127.0.0.1:8081")
        ps.set_defaults(fn=fn)

    for name, fn in (("info", cmd_info), ("cancel", cmd_cancel)):
        ps = sub.add_parser(name, help=f"{name} a job")
        ps.add_argument("job_id")
        ps.add_argument("--rest", default="127.0.0.1:8081")
        ps.set_defaults(fn=fn)

    ps = sub.add_parser("savepoint", help="trigger (or stop with) savepoint")
    ps.add_argument("job_id")
    ps.add_argument("target")
    ps.add_argument("--stop", action="store_true")
    ps.add_argument("--drain", action="store_true")
    ps.add_argument("--rest", default="127.0.0.1:8081")
    ps.set_defaults(fn=cmd_savepoint)

    ps = sub.add_parser("query", help="queryable-state lookup")
    ps.add_argument("job_id")
    ps.add_argument("operator")
    ps.add_argument("key")
    ps.add_argument("--key-type", default="auto",
                    choices=["auto", "int", "float", "string"],
                    help="force the key's type (string keys that look "
                    "numeric need 'string')")
    ps.add_argument("--namespace", type=int)
    ps.add_argument("--rest", default="127.0.0.1:8081")
    ps.set_defaults(fn=cmd_query)

    ps = sub.add_parser("inspect", help="inspect a checkpoint/savepoint")
    ps.add_argument("path")
    ps.set_defaults(fn=cmd_inspect)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
