"""Command-line submitters (the port's own copy of the JAX package's
cli/main.py): ``submit`` (a configured job against the configured
provisioner) and ``local`` (one command on the local mini-cluster), as
``python -m tony_tpu_torch.cli.main``:

    python -m tony_tpu_torch.cli.main submit --conf job.json [-D k=v ...]
    python -m tony_tpu_torch.cli.main local --command "python train.py" \
        [--instances N] [-D k=v ...]
    python -m tony_tpu_torch.cli.main serve ...     # cli/serve.py's argv

``notebook``, ``history``, ``trace`` and ``slo`` wait for the portal and SLO
items of ROADMAP.md queue 1, ``route`` for the router's: each is refused by
name. The CLI exits 0 when the job SUCCEEDED, 1 otherwise.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import time

from ..conf import TonyConf, keys

# subcommands of the JAX package's CLI that wait for a ROADMAP.md item
NOT_PORTED = {
    "notebook": "the portal, notebook, proxy and native/",
    "history": "the portal, notebook, proxy and native/",
    "trace": "the portal, notebook, proxy and native/",
    "slo": "the autoscaler, the arbiter and the metrics hub/SLOs",
    "route": "the router, its role and HA",
}


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--conf", action="append", default=[],
                   help="config file (json), repeatable; later wins")
    p.add_argument("--conf-override", "-D", action="append", default=[],
                   metavar="K=V", help="config override, repeatable")


def _build_client(args, extra: dict | None = None):
    from ..client import TonyClient

    conf = TonyConf.resolve(conf_files=args.conf,
                            overrides=args.conf_override)
    for k, v in (extra or {}).items():
        conf.set(k, v)
    client = TonyClient(conf)

    # force-kill the app on SIGINT and SIGTERM, like ClusterSubmitter.java:
    # 49-84 (the driver and executors are in their own sessions and would
    # outlive us)
    def _on_signal(signum, frame):
        print("interrupt: killing application", file=sys.stderr)
        client.stop()
        sys.exit(128 + signum)

    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)
    return client


def cmd_submit(args) -> int:
    client = _build_client(args)
    client.add_listener(_print_task_updates)
    return client.run()


def cmd_local(args) -> int:
    extra = {
        keys.CLUSTER_PROVISIONER: "local",
        keys.instances_key("worker"): args.instances,
        keys.command_key("worker"): args.command,
    }
    client = _build_client(args, extra)
    client.add_listener(_print_task_updates)
    return client.run()


_last_printed: dict[str, str] = {}
_url_printed: set = set()


def _print_task_updates(infos) -> None:
    for info in infos:
        prev = _last_printed.get(info.task_id)
        if prev != info.status:
            _last_printed[info.task_id] = info.status
            # log location once per task, as soon as it is known
            show_url = info.url and info.task_id not in _url_printed
            if show_url:
                _url_printed.add(info.task_id)
            print(f"[{time.strftime('%H:%M:%S')}] {info.task_id}: "
                  f"{info.status}"
                  + (f" @ {info.host}:{info.port}" if info.port > 0 else "")
                  + (f" logs: {info.url}" if show_url else ""),
                  file=sys.stderr)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.WARNING)
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"{argv[0]} is not ported yet (ROADMAP.md queue 1: "
              f"{NOT_PORTED[argv[0]]})", file=sys.stderr)
        return 2
    # `serve` owns its argparser; hand the argv through
    if argv and argv[0] == "serve":
        from . import serve as serve_mod

        return serve_mod.main(argv[1:])

    parser = argparse.ArgumentParser(prog="python -m tony_tpu_torch.cli.main")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("submit", help="submit a configured job")
    _add_common(p)
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("local",
                       help="run a command on the local mini-cluster")
    _add_common(p)
    p.add_argument("--command", required=True)
    p.add_argument("--instances", type=int, default=1)
    p.set_defaults(fn=cmd_local)

    sub.add_parser("serve", add_help=False,
                   help="serve a model over HTTP (cli/serve.py)")
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
