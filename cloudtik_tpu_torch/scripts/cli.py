"""`tik` — the CLI.

Reference parity: python/cloudtik/scripts/ (SURVEY.md §2.6): `cloudtik`
start/stop/attach/exec/submit/scale/rsync/status/info/monitor + workspace
group + on-node `cloudtik node start/stop`.
"""

from __future__ import annotations

import json
import os
import sys

import click

import cloudtik_tpu_torch
from cloudtik_tpu_torch.config.loader import load_yaml, prepare_config
from cloudtik_tpu_torch.config.schema import (
    ConfigError, validate_cluster_config, validate_workspace_config)
from cloudtik_tpu_torch.utils.cli_logger import cli_logger


def _load(config_file: str):
    try:
        config = prepare_config(
            load_yaml(config_file),
            search_dirs=[os.path.dirname(os.path.abspath(config_file))])
        validate_cluster_config(config)
        return config
    except (ConfigError, FileNotFoundError) as e:
        cli_logger.abort(str(e))


@click.group()
@click.version_option(cloudtik_tpu_torch.__version__, prog_name="tik")
@click.option("-v", "--verbose", count=True, help="Increase verbosity.")
def cli(verbose: int):
    cli_logger.verbosity = verbose


# ---------------------------------------------------------------- cluster --

@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--restart-only", is_flag=True)
@click.option("--no-restart", is_flag=True)
@click.option("--yes", "-y", is_flag=True)
def start(config_file, restart_only, no_restart, yes):
    """Create or update a cluster."""
    from cloudtik_tpu_torch.control import cluster_operator
    cluster_operator.create_or_update_cluster(
        _load(config_file), restart_only=restart_only, no_restart=no_restart)


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--workers-only", is_flag=True)
@click.option("--keep-min-workers", is_flag=True)
@click.option("--hard", is_flag=True)
@click.option("--yes", "-y", is_flag=True)
def stop(config_file, workers_only, keep_min_workers, hard, yes):
    """Tear down a cluster."""
    from cloudtik_tpu_torch.control import cluster_operator
    cli_logger.confirm(yes, "Tear down the cluster?")
    cluster_operator.teardown_cluster(
        _load(config_file), workers_only=workers_only,
        keep_min_workers=keep_min_workers, hard=hard)


@cli.command(name="exec")
@click.argument("config_file", type=click.Path(exists=True))
@click.argument("cmd")
@click.option("--node-ip", default=None)
@click.option("--all-nodes", is_flag=True)
@click.option("--tmux", is_flag=True)
@click.option("--stop", is_flag=True, help="Tear down after the command.")
@click.option("--job-waiter", default=None,
              help="Completion waiter gating --stop: tmux, screen, a "
                   "runtime name, or chain:a,b.")
def exec_cmd(config_file, cmd, node_ip, all_nodes, tmux, stop, job_waiter):
    """Run a shell command on the cluster."""
    from cloudtik_tpu_torch.control import cluster_operator
    out = cluster_operator.exec_on_cluster(
        _load(config_file), cmd, node_ip=node_ip, all_nodes=all_nodes,
        tmux=tmux, stop=stop, with_output=True,
        job_waiter_name=job_waiter)
    if out:
        click.echo(out)


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
@click.argument("script", type=click.Path(exists=True))
@click.argument("script_args", nargs=-1)
@click.option("--tmux", is_flag=True)
@click.option("--stop", is_flag=True)
@click.option("--job-waiter", default=None,
              help="Completion waiter gating --stop: tmux, screen, a "
                   "runtime name, or chain:a,b.")
def submit(config_file, script, script_args, tmux, stop, job_waiter):
    """Upload and run a job file via the matching runtime."""
    from cloudtik_tpu_torch.control import cluster_operator
    out = cluster_operator.submit_to_cluster(
        _load(config_file), script, list(script_args), tmux=tmux,
        stop=stop, job_waiter_name=job_waiter)
    if out:
        click.echo(out)


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--num-workers", type=int, default=None)
@click.option("--num-cpus", type=int, default=None)
@click.option("--node-type", default=None)
def scale(config_file, num_workers, num_cpus, node_type):
    """Request cluster resources; the controller converges to them."""
    from cloudtik_tpu_torch.control import cluster_operator
    cluster_operator.scale_cluster(
        _load(config_file), num_cpus=num_cpus, num_workers=num_workers,
        node_type=node_type)


@cli.command(name="rsync-up")
@click.argument("config_file", type=click.Path(exists=True))
@click.argument("source")
@click.argument("target")
def rsync_up(config_file, source, target):
    from cloudtik_tpu_torch.control import cluster_operator
    cluster_operator.rsync_cluster(_load(config_file), source, target)


@cli.command(name="rsync-down")
@click.argument("config_file", type=click.Path(exists=True))
@click.argument("source")
@click.argument("target")
def rsync_down(config_file, source, target):
    from cloudtik_tpu_torch.control import cluster_operator
    cluster_operator.rsync_cluster(
        _load(config_file), source, target, down=True)


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
def status(config_file):
    """Show node status summary."""
    from cloudtik_tpu_torch.control import cluster_operator
    click.echo(json.dumps(
        cluster_operator.get_cluster_status(_load(config_file)),
        indent=2, default=str))


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
def info(config_file):
    """Show cluster info incl. runtime endpoints."""
    from cloudtik_tpu_torch.control import cluster_operator
    click.echo(json.dumps(
        cluster_operator.get_cluster_info(_load(config_file)),
        indent=2, default=str))


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
def monitor(config_file):
    """Show the controller's latest reconciliation status."""
    from cloudtik_tpu_torch.control import cluster_operator
    click.echo(cluster_operator.monitor_cluster(_load(config_file)))


@cli.command(name="enable-local-proxy")
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--port", type=int, default=None,
              help="Local SOCKS5 port (default 6860).")
def enable_local_proxy(config_file, port):
    """Start a SOCKS5 proxy through the head so local tools reach
    in-cluster services (reference: cloudtik enable-local-proxy)."""
    from cloudtik_tpu_torch.control import cluster_operator, proxy
    from cloudtik_tpu_torch.providers.factory import create_node_provider
    config = cluster_operator.bootstrap_config(_load(config_file))
    provider = create_node_provider(
        config["provider"], config["cluster_name"])
    head_id, _ = cluster_operator.head_executor(config, provider)
    head_ip = provider.external_ip(head_id) \
        or provider.internal_ip(head_id)
    pid, bound = proxy.start_proxy(
        config["cluster_name"], head_ip, config.get("auth", {}),
        port=port or proxy.DEFAULT_PROXY_PORT)
    cli_logger.success(
        "SOCKS5 proxy on localhost:{} (pid {}).", bound, pid)


@cli.command(name="disable-local-proxy")
@click.argument("config_file", type=click.Path(exists=True))
def disable_local_proxy(config_file):
    """Stop the cluster's local SOCKS5 proxy."""
    from cloudtik_tpu_torch.control import cluster_operator, proxy
    config = cluster_operator.bootstrap_config(_load(config_file))
    if proxy.stop_proxy(config["cluster_name"]):
        cli_logger.success("Proxy stopped.")
    else:
        cli_logger.info("No proxy running.")


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--service", "services", multiple=True,
              help="Runtime service to tunnel (port from its "
                   "declaration); repeatable.")
@click.option("--forward", "forwards", multiple=True,
              help="Explicit local:remote_host:remote_port; repeatable.")
@click.option("--stop", "stop_", is_flag=True,
              help="Stop the cluster's tunnel.")
def tunnel(config_file, services, forwards, stop_):
    """Port-forward local ports to in-cluster services via the head
    (reference: cluster tunnel requests / enable-local-proxy)."""
    from cloudtik_tpu_torch.control import cluster_operator, proxy
    config = cluster_operator.bootstrap_config(_load(config_file))
    if stop_:
        if proxy.stop_tunnel(config["cluster_name"]):
            cli_logger.success("Tunnel stopped.")
        else:
            cli_logger.info("No tunnel running.")
        return
    fwd = []
    for spec in forwards:
        # local:host:port where host may itself contain colons (IPv6):
        # local is the first field, the remote port the last
        local_s, _, rest = spec.partition(":")
        host, _, remote_s = rest.rpartition(":")
        try:
            fwd.append((int(local_s), host or "localhost",
                        int(remote_s)))
        except ValueError:
            raise click.ClickException(
                f"bad --forward {spec!r}; expected "
                "local_port:remote_host:remote_port")
    if services:
        from cloudtik_tpu_torch.runtimes.registry import iter_runtimes
        declared = {}
        for runtime in iter_runtimes(config):
            declared.update(
                runtime.get_runtime_services(config, "127.0.0.1") or {})
        for name in services:
            svc = declared.get(name)
            if svc is None:
                raise click.ClickException(
                    f"unknown service {name!r}; declared: "
                    f"{sorted(declared)}")
            fwd.append((svc["port"], "localhost", svc["port"]))
    if not fwd:
        raise click.ClickException("nothing to forward "
                                   "(--service or --forward)")
    from cloudtik_tpu_torch.providers.factory import create_node_provider
    provider = create_node_provider(
        config["provider"], config["cluster_name"])
    head_id, _ = cluster_operator.head_executor(config, provider)
    head_ip = provider.external_ip(head_id) \
        or provider.internal_ip(head_id)
    pid = proxy.start_tunnel(
        config["cluster_name"], head_ip, config.get("auth", {}), fwd)
    for local, host, remote in fwd:
        cli_logger.info("localhost:{} -> {}:{}", local, host, remote)
    cli_logger.success("Tunnel running (pid {}).", pid)


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--node", "node_id", default=None,
              help="Only this node's logs.")
@click.option("--grep", default=None, help="Regex filter.")
@click.option("--follow", "-f", is_flag=True,
              help="Keep streaming new lines.")
def logs(config_file, node_id, grep, follow):
    """Stream log lines published by the node log agents."""
    from cloudtik_tpu_torch.control import cluster_operator
    try:
        for line in cluster_operator.tail_cluster_logs(
                _load(config_file), node_id=node_id, grep=grep,
                follow=follow):
            click.echo(line)
    except KeyboardInterrupt:
        pass


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
def attach(config_file):
    """Open an interactive shell on the head node."""
    from cloudtik_tpu_torch.control import cluster_operator
    from cloudtik_tpu_torch.providers.factory import create_node_provider
    config = cluster_operator.bootstrap_config(_load(config_file))
    provider = create_node_provider(
        config["provider"], config["cluster_name"])
    _head_id, executor = cluster_operator.head_executor(config, provider)
    os.system(executor.remote_shell_command_str())


@cli.command(name="validate")
@click.argument("config_file", type=click.Path(exists=True))
def validate(config_file):
    """Validate a cluster config file."""
    _load(config_file)
    cli_logger.success("Config is valid.")


@cli.command(name="show-config")
@click.argument("config_file", type=click.Path(exists=True))
def show_config(config_file):
    """Print the fully-resolved cluster config (templates + defaults)."""
    click.echo(json.dumps(_load(config_file), indent=2, default=str))


@cli.command(name="cluster-dump")
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--output", "-o", default=None,
              help="Archive path (default: tik-dump-<cluster>-<ts>.tar.gz)")
@click.option("--local-only", is_flag=True,
              help="Skip pulling per-node logs.")
def cluster_dump_cmd(config_file, output, local_only):
    """Collect a debug archive (logs/configs/processes) from the cluster.

    Reference parity: `cloudtik cluster-dump` (cluster_dump.py:783)."""
    from cloudtik_tpu_torch.control import cluster_operator
    path = cluster_operator.dump_cluster(
        _load(config_file), output_path=output,
        include_nodes=not local_only)
    click.echo(path)


# ------------------------------------------------------------------- head --

@cli.group()
def head():
    """On-head cluster operations (run on the head node).

    Reference parity: `cloudtik head` group (scripts/head_scripts.py) —
    attach/exec/scale/teardown and status surfaces read straight from the
    head's state tables instead of tunnelling through SSH."""


def _head_state():
    from cloudtik_tpu_torch.control.services import load_bootstrap_config
    from cloudtik_tpu_torch.control.state import StateClient, TcpStateBackend
    from cloudtik_tpu_torch.utils.constants import TIK_STATE_PORT_DEFAULT
    config = load_bootstrap_config()
    state = StateClient(TcpStateBackend(
        "127.0.0.1", config.get("state_port", TIK_STATE_PORT_DEFAULT)))
    return config, state


@head.command(name="process-status")
def head_process_status():
    """Per-node runtime process/status tables from the head store."""
    from cloudtik_tpu_torch.control.state import TABLE_PROCESSES
    _config, state = _head_state()
    click.echo(json.dumps({
        "processes": state.table_list(TABLE_PROCESSES),
        "node_status": state.table_list("node_status"),
        "runtime_status": state.table_list("runtime_status"),
    }, indent=2, default=str))


@head.command(name="resource-metrics")
def head_resource_metrics():
    """Per-node resource metrics published by the node agents, plus
    heartbeat freshness, runtime-reported lost nodes, and per-host
    training progress with straggler detection."""
    import time as _time

    from cloudtik_tpu_torch.control.state import TABLE_HEARTBEAT, TABLE_METRICS
    from cloudtik_tpu_torch.telemetry import stepprof
    _config, state = _head_state()
    heartbeats = state.table_list(TABLE_HEARTBEAT)
    now = _time.time()
    heartbeat_age_s = {
        node_id: round(now - hb["time"], 3)
        for node_id, hb in heartbeats.items() if hb.get("time")}
    # the controller's last reconcile summary carries the merged
    # lost-node view (scaling policies + runtime-published states)
    controller = state.table_list("controller").get("status", {})
    lost_nodes = (controller.get("summary", {}).get("metrics", {})
                  .get("lost_nodes", {}))
    train_progress = state.table_list(stepprof.TABLE_TRAIN_PROGRESS)
    click.echo(json.dumps({
        "metrics": state.table_list(TABLE_METRICS),
        "heartbeats": heartbeats,
        "heartbeat_age_s": heartbeat_age_s,
        "lost_nodes": lost_nodes,
        "train_progress": train_progress,
        "stragglers": stepprof.detect_stragglers(train_progress,
                                                 now=now),
    }, indent=2, default=str))


@head.command(name="scale")
@click.option("--num-workers", type=int, default=None)
@click.option("--num-cpus", type=int, default=None)
@click.option("--node-type", default=None)
def head_scale(num_workers, num_cpus, node_type):
    """Publish a scale request to the local controller."""
    from cloudtik_tpu_torch.control import cluster_operator
    config, _state = _head_state()
    cluster_operator.scale_cluster(
        config, num_cpus=num_cpus, num_workers=num_workers,
        node_type=node_type, on_head=True)


@head.command(name="exec")
@click.argument("cmd")
@click.option("--node-id", default=None,
              help="Target node (default: run locally on the head).")
def head_exec(cmd, node_id):
    """Run a command on this head or a worker (via the provider)."""
    from cloudtik_tpu_torch.control.services import load_bootstrap_config
    from cloudtik_tpu_torch.providers.factory import create_node_provider
    from cloudtik_tpu_torch.utils.call_context import CallContext
    config = load_bootstrap_config()
    if node_id is None:
        sys.exit(os.system(cmd) >> 8)
    provider = create_node_provider(
        config["provider"], config["cluster_name"])
    executor = provider.get_command_executor(
        CallContext(), f"[{node_id}] ", node_id,
        config.get("auth", {}), config["cluster_name"],
        use_internal_ip=True, docker_config=config.get("docker"))
    executor.run(cmd)


@head.command(name="teardown")
@click.option("--workers-only", is_flag=True)
@click.option("--hard", is_flag=True)
def head_teardown(workers_only, hard):
    """Tear the cluster down from the head (reference: head_scripts
    teardown)."""
    from cloudtik_tpu_torch.control import cluster_operator
    from cloudtik_tpu_torch.control.services import load_bootstrap_config
    config = load_bootstrap_config()
    cluster_operator.teardown_cluster(
        config, workers_only=workers_only, hard=hard)


# -------------------------------------------------------------- workspace --

@cli.group()
def workspace():
    """Workspace (shared infra) operations."""


def _load_workspace(config_file: str):
    from cloudtik_tpu_torch.config.loader import fill_with_defaults
    config = fill_with_defaults(
        load_yaml(config_file),
        [os.path.dirname(os.path.abspath(config_file))])
    try:
        validate_workspace_config(config)
    except ConfigError as e:
        cli_logger.abort(str(e))
    return config


@workspace.command(name="create")
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--yes", "-y", is_flag=True)
def workspace_create(config_file, yes):
    from cloudtik_tpu_torch.control import workspace_operator
    workspace_operator.create_workspace(_load_workspace(config_file), yes=yes)


@workspace.command(name="delete")
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--yes", "-y", is_flag=True)
@click.option("--delete-managed-storage", is_flag=True)
def workspace_delete(config_file, yes, delete_managed_storage):
    from cloudtik_tpu_torch.control import workspace_operator
    workspace_operator.delete_workspace(
        _load_workspace(config_file), yes=yes,
        delete_managed_storage=delete_managed_storage)


@workspace.command(name="status")
@click.argument("config_file", type=click.Path(exists=True))
def workspace_status(config_file):
    from cloudtik_tpu_torch.control import workspace_operator
    click.echo(json.dumps(workspace_operator.get_workspace_status(
        _load_workspace(config_file)), indent=2, default=str))


# ------------------------------------------------------- storage/database --

@cli.group()
def storage():
    """Managed cloud-storage operations (reference: `cloudtik storage`)."""


def _storage_provider(config_file, name):
    from cloudtik_tpu_torch.providers.factory import create_storage_provider
    config = _load_workspace(config_file)
    return config, create_storage_provider(
        config["provider"], config["workspace_name"], name)


@storage.command(name="create")
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--name", default="data")
def storage_create(config_file, name):
    config, provider = _storage_provider(config_file, name)
    provider.create(config)
    cli_logger.success("Storage {} created.", name)


@storage.command(name="delete")
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--name", default="data")
@click.option("--yes", "-y", is_flag=True)
def storage_delete(config_file, name, yes):
    config, provider = _storage_provider(config_file, name)
    cli_logger.confirm(yes, "Delete storage {}?", name)
    provider.delete(config)
    cli_logger.success("Storage {} deleted.", name)


@storage.command(name="info")
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--name", default="data")
def storage_info(config_file, name):
    config, provider = _storage_provider(config_file, name)
    click.echo(json.dumps(provider.get_info(config), indent=2,
                          default=str))


@cli.group()
def database():
    """Managed cloud-database operations (reference: `cloudtik
    database`)."""


def _database_provider(config_file, name):
    from cloudtik_tpu_torch.providers.factory import create_database_provider
    config = _load_workspace(config_file)
    return config, create_database_provider(
        config["provider"], config["workspace_name"], name)


@database.command(name="create")
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--name", default="db")
def database_create(config_file, name):
    config, provider = _database_provider(config_file, name)
    provider.create(config)
    cli_logger.success("Database {} created.", name)


@database.command(name="delete")
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--name", default="db")
@click.option("--yes", "-y", is_flag=True)
def database_delete(config_file, name, yes):
    config, provider = _database_provider(config_file, name)
    cli_logger.confirm(yes, "Delete database {}?", name)
    provider.delete(config)
    cli_logger.success("Database {} deleted.", name)


@database.command(name="info")
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--name", default="db")
def database_info(config_file, name):
    config, provider = _database_provider(config_file, name)
    click.echo(json.dumps(provider.get_info(config), indent=2,
                          default=str))


# ---------------------------------------------------------------- runtime --

@cli.group()
def runtime():
    """On-node runtime lifecycle: install/configure/start/stop/status.

    Reference parity: `cloudtik runtime` group
    (scripts/runtime_scripts.py:338-343) run by the node updater on every
    node; here the delivery layer (runtimes/delivery.py) executes the same
    phases against the bootstrap config on this node."""


def _delivery_context(head_ip: str):
    from cloudtik_tpu_torch.control.services import load_bootstrap_config
    from cloudtik_tpu_torch.runtimes import delivery
    config = load_bootstrap_config()
    node_context = delivery.build_node_context(
        config,
        is_head=os.environ.get("TIK_NODE_KIND", "head") == "head",
        head_ip=head_ip,
        node_id=os.environ.get("TIK_NODE_ID", ""))
    return delivery, config, node_context


_runtimes_opt = click.option(
    "--runtimes", "-r", default=None,
    help="Comma-separated runtime names (default: all configured).")
_head_ip_opt = click.option("--head-ip", default="127.0.0.1")


def _names(runtimes):
    return [r.strip() for r in runtimes.split(",")] if runtimes else None


@runtime.command(name="install")
@_runtimes_opt
@_head_ip_opt
def runtime_install(runtimes, head_ip):
    """Verify/install runtime software on this node."""
    delivery, config, ctx = _delivery_context(head_ip)
    delivery.install_runtimes(config, ctx, _names(runtimes))
    cli_logger.success("Runtimes installed.")


@runtime.command(name="configure")
@_runtimes_opt
@_head_ip_opt
def runtime_configure(runtimes, head_ip):
    """Render runtime configuration on this node."""
    delivery, config, ctx = _delivery_context(head_ip)
    delivery.configure_runtimes(config, ctx, _names(runtimes))
    cli_logger.success("Runtimes configured.")


@runtime.command(name="services")
@click.argument("command", type=click.Choice(["start", "stop"]))
@_runtimes_opt
@_head_ip_opt
def runtime_services(command, runtimes, head_ip):
    """Start or stop runtime service processes on this node."""
    delivery, config, ctx = _delivery_context(head_ip)
    if command == "start":
        delivery.start_runtime_services(config, ctx, _names(runtimes))
        cli_logger.success("Runtime services started.")
    else:
        delivery.stop_runtime_services(config, ctx, _names(runtimes))
        cli_logger.success("Runtime services stopped.")


@runtime.command(name="status")
@_runtimes_opt
@_head_ip_opt
def runtime_status_cmd(runtimes, head_ip):
    """Show per-runtime delivery/health status on this node."""
    delivery, config, ctx = _delivery_context(head_ip)
    click.echo(json.dumps(delivery.runtime_status(
        config, _names(runtimes)), indent=2, default=str))


# ------------------------------------------------------------------- node --

@cli.group()
def node():
    """On-node operations (run on cluster nodes)."""


@node.command(name="start")
@click.option("--head", "is_head", is_flag=True)
@click.option("--node-id", default=None)
@click.option("--head-ip", default="127.0.0.1")
@click.option("--daemonize", is_flag=True,
              help="Fork to background and return.")
def node_start(is_head, node_id, head_ip, daemonize):
    """Boot this node's services (state server/controller/agents)."""
    from cloudtik_tpu_torch.control.services import (
        NodeServicesStarter, load_bootstrap_config)
    if daemonize:
        import subprocess
        args = [sys.executable, "-m", "cloudtik_tpu_torch.scripts.cli",
                "node", "start", "--head-ip", head_ip]
        if is_head:
            args.insert(5, "--head")
        if node_id:
            args += ["--node-id", node_id]
        log_dir = os.path.expanduser("~/.tik/logs")
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "node-services.log"), "ab") as log:
            subprocess.Popen(args, stdout=log, stderr=log,
                             start_new_session=True)
        cli_logger.success("Node services started in background.")
        return
    config = load_bootstrap_config()
    node_id = node_id or os.environ.get("TIK_NODE_ID", "head")
    from cloudtik_tpu_torch.utils.constants import TIK_STATE_PORT_DEFAULT
    starter = NodeServicesStarter(
        config, node_id, is_head=is_head, head_ip=head_ip,
        state_port=config.get("state_port", TIK_STATE_PORT_DEFAULT))
    if is_head:
        starter.start_head_processes()
    else:
        starter.start_node_processes()
    cli_logger.info("Node services running; Ctrl-C to stop.")
    starter.run_until_signal()


@node.command(name="stop")
def node_stop():
    """Stop this node's services."""
    import glob
    import signal
    from cloudtik_tpu_torch.utils.constants import TIK_RUN_DIR
    run_dir = os.path.expanduser(TIK_RUN_DIR)
    # pidfiles are cluster-scoped (node-services-<cluster>.pid); the bare
    # name is the pre-scoping legacy spelling
    pid_files = sorted(glob.glob(
        os.path.join(run_dir, "node-services-*.pid")))
    legacy = os.path.join(run_dir, "node-services.pid")
    if os.path.exists(legacy):
        pid_files.append(legacy)
    if not pid_files:
        cli_logger.info("No node services running.")
        return
    for pid_file in pid_files:
        try:
            with open(pid_file) as f:
                pid = int(f.read().strip())
        except (OSError, ValueError):
            continue
        try:
            os.kill(pid, signal.SIGTERM)
            cli_logger.success("Node services (pid {}) stopped.", pid)
        except ProcessLookupError:
            cli_logger.info("Process {} already gone.", pid)
            try:
                os.unlink(pid_file)
            except OSError:
                pass


@node.command(name="run")
@click.argument("command", nargs=-1, required=True)
def node_run(command):
    """Run a command on this node with the runtime environment loaded
    (reference: node_scripts `run`)."""
    import subprocess

    from cloudtik_tpu_torch.control.services import load_bootstrap_config
    from cloudtik_tpu_torch.runtimes.registry import iter_runtimes
    env = dict(os.environ)
    try:
        config = load_bootstrap_config()
    except FileNotFoundError:
        config = {}
    for runtime in iter_runtimes(config):
        try:
            extra = runtime.with_environment_variables(
                config, None, os.environ.get("TIK_NODE_ID", ""))
        except Exception:
            extra = None
        if extra:
            env.update({k: str(v) for k, v in extra.items()})
    import shlex
    raise SystemExit(subprocess.call(shlex.join(command), shell=True,
                                     env=env))


@node.command(name="dump")
@click.option("--output", default=None, help="archive path (.tar.gz)")
def node_dump(output):
    """Collect this node's logs/configs/processes into an archive
    (reference: node_scripts `dump`)."""
    from cloudtik_tpu_torch.control.cluster_dump import create_archive
    path = create_archive(output_path=output, cluster_name="node")
    cli_logger.success("Node debug archive written to {}.", path)


# -------------------------------------------------------------- telemetry --

def _telemetry_url(url, config_file, path):
    """Resolve the telemetry endpoint: explicit --url wins; --config
    resolves the cluster's head ip through the provider (the same
    machinery `tik tunnel`/`attach` use); default is this host."""
    from cloudtik_tpu_torch.utils.constants import TIK_TELEMETRY_PORT_DEFAULT
    if url is None and config_file:
        from cloudtik_tpu_torch.control import cluster_operator
        from cloudtik_tpu_torch.providers.factory import create_node_provider
        config = cluster_operator.bootstrap_config(_load(config_file))
        provider = create_node_provider(
            config["provider"], config["cluster_name"])
        head_id, _ = cluster_operator.head_executor(config, provider)
        head_ip = provider.external_ip(head_id) \
            or provider.internal_ip(head_id)
        port = config.get("telemetry_port", TIK_TELEMETRY_PORT_DEFAULT)
        url = f"http://{head_ip}:{port}"
    if url is None:
        url = f"http://127.0.0.1:{TIK_TELEMETRY_PORT_DEFAULT}"
    return url.rstrip("/") + path


def _telemetry_fetch(url, config_file, path):
    import urllib.error
    import urllib.request
    full = _telemetry_url(url, config_file, path)
    try:
        with urllib.request.urlopen(full, timeout=10) as resp:
            return resp.read().decode(errors="replace")
    except (urllib.error.URLError, OSError) as e:
        raise click.ClickException(
            f"cannot fetch {full}: {e} (is a telemetry endpoint up? "
            "head services and the nodex exporter serve one; see "
            "docs/observability.md)")


_telemetry_url_opt = click.option(
    "--url", default=None,
    help="Telemetry endpoint (default http://127.0.0.1:<telemetry "
         "port>, or the cluster head's with --config).")
_telemetry_config_opt = click.option(
    "--config", "config_file", default=None,
    type=click.Path(exists=True),
    help="Cluster config; fetches from the head's telemetry port.")


@cli.group()
def trace():
    """Tracing spans: export/summarize the span ring of a tik process
    (docs/observability.md).  Every long-lived process keeps a bounded
    ring of finished spans; `export` emits chrome://tracing JSON."""


@trace.command(name="export")
@_telemetry_url_opt
@_telemetry_config_opt
@click.option("--output", "-o", default=None,
              help="Write Chrome-trace JSON here (default: stdout).")
def trace_export(url, config_file, output):
    """Export the span ring as Chrome-trace JSON."""
    body = _telemetry_fetch(url, config_file, "/trace")
    try:
        trace_json = json.loads(body)
    except ValueError:
        raise click.ClickException("endpoint returned non-JSON trace")
    if output:
        with open(output, "w") as f:
            json.dump(trace_json, f, indent=1)
        cli_logger.success(
            "Wrote {} events to {}.",
            len(trace_json.get("traceEvents", [])), output)
    else:
        click.echo(json.dumps(trace_json, indent=1))


@trace.command(name="summary")
@_telemetry_url_opt
@_telemetry_config_opt
def trace_summary_cmd(url, config_file):
    """Per-span-name count/mean/max over the span ring."""
    body = _telemetry_fetch(url, config_file, "/trace/summary")
    try:
        summary = json.loads(body)
    except ValueError:
        raise click.ClickException(
            "endpoint returned non-JSON trace summary")
    if not summary:
        cli_logger.info("No spans recorded.")
        return
    width = max(len(name) for name in summary)
    click.echo(f"{'span':<{width}}  {'count':>7}  {'mean':>10}  "
               f"{'max':>10}  {'total':>10}")
    for name, entry in summary.items():
        click.echo(
            f"{name:<{width}}  {entry['count']:>7}  "
            f"{entry['mean_s'] * 1e3:>8.2f}ms  "
            f"{entry['max_s'] * 1e3:>8.2f}ms  "
            f"{entry['total_s'] * 1e3:>8.2f}ms")


@cli.group()
def metrics():
    """Telemetry metrics registry surfaces (docs/observability.md)."""


@metrics.command(name="dump")
@_telemetry_url_opt
@_telemetry_config_opt
@click.option("--json", "as_json", is_flag=True,
              help="Parse the exposition into JSON samples.")
def metrics_dump(url, config_file, as_json):
    """Dump the Prometheus exposition of a tik process."""
    body = _telemetry_fetch(url, config_file, "/metrics")
    if as_json:
        from cloudtik_tpu_torch.telemetry import parse_prometheus
        click.echo(json.dumps(parse_prometheus(body), indent=1))
    else:
        click.echo(body, nl=False)


# ---------------------------------------------------------------- goodput --

@cli.command(name="goodput")
@_telemetry_url_opt
@_telemetry_config_opt
@click.option("--file", "snapshot_file", default=None,
              type=click.Path(exists=True),
              help="Read a ledger snapshot JSON (written via "
                   "TIK_GOODPUT_SNAPSHOT) instead of fetching "
                   "/metrics.")
@click.option("--job", default=None,
              help="Only this job label (default: every job).")
@click.option("--json", "as_json", is_flag=True,
              help="Emit the breakdown(s) as JSON.")
def goodput_cmd(url, config_file, snapshot_file, job, as_json):
    """Where every TPU-second went: the goodput bucket breakdown.

    Buckets (docs/observability.md "Goodput ledger"): step_compute,
    compile, data_wait, host_transfer, checkpoint_save,
    checkpoint_restore, restart_replay, elastic_remesh, slot_idle,
    idle — summing to total wall time."""
    from cloudtik_tpu_torch.telemetry import goodput as tgoodput
    if snapshot_file:
        with open(snapshot_file) as f:
            snap = json.load(f)
        records = snap if isinstance(snap, list) else [snap]
        if job is not None:
            records = [r for r in records if r.get("job") == job]
    else:
        from cloudtik_tpu_torch.telemetry import parse_prometheus
        body = _telemetry_fetch(url, config_file, "/metrics")
        records = tgoodput.breakdown_from_samples(
            parse_prometheus(body), job=job)
    if as_json:
        click.echo(json.dumps(records, indent=1))
        return
    if not records:
        cli_logger.info("No goodput ledger data (is a job running "
                        "with telemetry on?).")
        return
    for record in records:
        click.echo(tgoodput.format_breakdown(record))


# ----------------------------------------------------------------- alerts --

@cli.group(name="alerts")
def alerts_group():
    """Alert rules the head collector evaluates every scrape cycle
    (docs/observability.md "Alert rules")."""


@alerts_group.command(name="list")
@click.option("--url", default=None,
              help="Collector base URL (default "
                   "http://127.0.0.1:9090); fetches /api/v1/alerts.")
@click.option("--catalog", is_flag=True,
              help="Print the built-in rule catalog instead of live "
                   "state (no collector needed).")
@click.option("--json", "as_json", is_flag=True)
def alerts_list(url, catalog, as_json):
    """Show live alert state from the collector (or the catalog)."""
    from cloudtik_tpu_torch.runtimes.prometheus.alerts import (
        default_alert_rules)
    if catalog:
        rows = [{"name": r.name, "kind": r.kind, "metric": r.metric,
                 "severity": r.severity, "summary": r.summary}
                for r in default_alert_rules()]
    else:
        import urllib.error
        import urllib.request
        base = (url or "http://127.0.0.1:9090").rstrip("/")
        try:
            with urllib.request.urlopen(
                    base + "/api/v1/alerts", timeout=10) as resp:
                payload = json.loads(resp.read().decode())
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise click.ClickException(
                f"cannot fetch {base}/api/v1/alerts: {e} (is the "
                "built-in collector running? use --catalog for the "
                "static rule list)")
        rows = payload.get("data", {}).get("alerts", [])
    if as_json:
        click.echo(json.dumps(rows, indent=1))
        return
    if not rows:
        cli_logger.info("No alert rules.")
        return
    width = max(len(r["name"]) for r in rows)
    for row in rows:
        state = row.get("state", "-")
        value = row.get("value")
        value_s = f"{value:.4g}" if isinstance(value, (int, float)) \
            else "-"
        click.echo(f"{row['name']:<{width}}  {state:<7}  "
                   f"{row.get('severity', '-'):<8}  value={value_s}  "
                   f"{row.get('summary', '')}")


@alerts_group.command(name="eval")
@_telemetry_url_opt
@_telemetry_config_opt
@click.option("--file", "exposition_file", default=None,
              type=click.Path(exists=True),
              help="Evaluate against a saved Prometheus exposition "
                   "instead of fetching /metrics.")
@click.option("--cycles", default=3, show_default=True,
              help="Evaluation cycles (rules fire after their "
                   "for_cycles consecutive breaches).")
@click.option("--interval", default=0.0, show_default=True,
              help="Seconds between cycles (re-fetches with --url).")
@click.option("--fail-on-firing", is_flag=True,
              help="Exit 2 when any rule ends up firing (CI gate).")
@click.option("--json", "as_json", is_flag=True)
def alerts_eval(url, config_file, exposition_file, cycles, interval,
                fail_on_firing, as_json):
    """One-shot rule evaluation against a metrics exposition."""
    import time as _time

    from cloudtik_tpu_torch.runtimes.prometheus.alerts import (
        AlertEngine, samples_from_exposition)
    engine = AlertEngine()

    def _samples():
        if exposition_file:
            with open(exposition_file) as f:
                return samples_from_exposition(f.read())
        return samples_from_exposition(
            _telemetry_fetch(url, config_file, "/metrics"))

    state = []
    for cycle in range(max(int(cycles), 1)):
        if cycle and interval:
            _time.sleep(interval)
        state = engine.evaluate(_samples())
    if as_json:
        click.echo(json.dumps(state, indent=1))
    else:
        width = max(len(a["name"]) for a in state)
        for alert in state:
            value = alert.get("value")
            value_s = f"{value:.4g}" \
                if isinstance(value, (int, float)) else "-"
            click.echo(f"{alert['name']:<{width}}  "
                       f"{alert['state']:<7}  value={value_s}  "
                       f"{alert['summary']}")
    firing = [a for a in state if a["state"] == "firing"]
    if not as_json:
        if firing:
            cli_logger.warning("{} rule(s) firing.", len(firing))
        else:
            cli_logger.success("No rules firing.")
    if firing and fail_on_firing:
        sys.exit(2)


# -------------------------------------------------------------------- slo --

@cli.group(name="slo")
def slo_group():
    """Serving SLOs and error-budget burn rates, evaluated by the head
    collector every scrape cycle (docs/observability.md
    "SLOs & burn rates")."""


@slo_group.command(name="status")
@click.option("--url", default=None,
              help="Collector base URL (default "
                   "http://127.0.0.1:9090); fetches /api/v1/slos.")
@click.option("--file", "exposition_file", default=None,
              type=click.Path(exists=True),
              help="Evaluate the catalog against a saved Prometheus "
                   "exposition instead (single cycle: windows see the "
                   "since-boot population).")
@click.option("--catalog", is_flag=True,
              help="Print the built-in SLO catalog (no collector "
                   "needed).")
@click.option("--json", "as_json", is_flag=True)
def slo_status(url, exposition_file, catalog, as_json):
    """Per-SLO state, burn rates, and error budget remaining."""
    from cloudtik_tpu_torch.telemetry.slo import (
        catalog_from_env, evaluate_exposition)
    if catalog:
        # the collector's catalog: defaults + TIK_SLO_TENANTS
        # per-tenant SLOs, so the operator sees what will evaluate
        rows = [{"name": s.name, "kind": s.kind, "metric": s.metric,
                 "objective": s.objective,
                 "threshold_s": s.threshold_s or None,
                 "burn_threshold": s.burn_threshold,
                 "summary": s.summary}
                for s in catalog_from_env()]
    elif exposition_file:
        with open(exposition_file) as f:
            rows = evaluate_exposition(f.read(), catalog_from_env())
    else:
        import urllib.error
        import urllib.request
        base = (url or "http://127.0.0.1:9090").rstrip("/")
        try:
            with urllib.request.urlopen(
                    base + "/api/v1/slos", timeout=10) as resp:
                payload = json.loads(resp.read().decode())
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise click.ClickException(
                f"cannot fetch {base}/api/v1/slos: {e} (is the "
                "built-in collector running? use --catalog for the "
                "static SLO list, or --file against a saved "
                "exposition)")
        rows = payload.get("data", {}).get("slos", [])
    if as_json:
        click.echo(json.dumps(rows, indent=1))
        return
    if not rows:
        cli_logger.info("No SLOs.")
        return
    width = max(len(r["name"]) for r in rows)

    def _num(value, fmt="{:.2f}"):
        return fmt.format(value) if isinstance(value, (int, float)) \
            else "-"

    for row in rows:
        state = row.get("state", "-")
        budget = row.get("budget_remaining")
        budget_s = f"{budget * 100:.1f}%" \
            if isinstance(budget, (int, float)) else "-"
        click.echo(
            f"{row['name']:<{width}}  {state:<7}  "
            f"budget={budget_s:<8}  "
            f"burn fast={_num(row.get('burn_fast'))} "
            f"slow={_num(row.get('burn_slow'))}  "
            f"{row.get('summary', '')}")
    firing = [r for r in rows if r.get("state") == "firing"]
    if firing:
        cli_logger.warning("{} SLO(s) burning.", len(firing))


# ---------------------------------------------------------------- profile --

@cli.group(name="profile")
def profile_group():
    """On-demand xprof capture windows inside a running trainer
    (docs/observability.md)."""


@profile_group.command(name="capture")
@click.option("--steps", default=5, show_default=True,
              help="Training steps to trace.")
@click.option("--output", "-o", default="~/.tik/xprof",
              show_default=True, help="Trace output directory.")
@click.option("--request-path", default=None,
              help="Request file path (default: <tik home>/"
                   "profile-request.json; TIK_PROFILE_REQUEST "
                   "overrides).")
def profile_capture(steps, output, request_path):
    """Ask the next training window to capture an xprof trace.

    The trainer polls for the request at every log window and runs
    `jax.profiler` for N steps — the same mechanism bench.py wires via
    TIK_BENCH_PROFILE.  View the output with tensorboard/xprof."""
    from cloudtik_tpu_torch.telemetry import stepprof
    path = stepprof.request_capture(steps, output, request_path)
    cli_logger.success(
        "Capture request written to {} ({} step(s) -> {}); the next "
        "training log window picks it up.", path, steps, output)


# ---------------------------------------------------------------- cluster --

@cli.group()
def cluster():
    """Cluster-wide observability aggregated on the head
    (docs/observability.md)."""


@cluster.group(name="trace")
def cluster_trace():
    """Cross-node traces: scrape every node's /trace endpoint
    (discovered from the prometheus runtime's file-SD targets) and
    stitch the spans by trace_id into one Chrome-trace with a process
    lane per node."""


def _trace_collector(conf_dir):
    from cloudtik_tpu_torch.runtimes.prometheus.trace_collector import (
        TraceCollector)
    if conf_dir is None:
        from cloudtik_tpu_torch.utils.constants import tik_home
        conf_dir = os.path.join(tik_home(), "prometheus")
    return TraceCollector(conf_dir)


_conf_dir_opt = click.option(
    "--conf-dir", default=None,
    help="Prometheus file-SD config dir holding targets.json "
         "(default: <tik home>/prometheus).")


@cluster_trace.command(name="export")
@_conf_dir_opt
@click.option("--trace-id", default=None,
              help="Only spans of this trace.")
@click.option("--output", "-o", default=None,
              help="Write the stitched Chrome-trace here "
                   "(default: stdout).")
def cluster_trace_export(conf_dir, trace_id, output):
    """Export one stitched Chrome-trace across all nodes."""
    collector = _trace_collector(conf_dir)
    trace, sources = collector.export(trace_id=trace_id)
    if not sources:
        raise click.ClickException(
            "no trace targets discovered (is targets.json rendered? "
            "see docs/observability.md)")
    for source in sources:
        if source["error"]:
            cli_logger.warning("target {} unreachable: {}",
                               source["address"], source["error"])
    if output:
        with open(output, "w") as f:
            json.dump(trace, f, indent=1)
        cli_logger.success(
            "Wrote {} events from {} node(s) to {}.",
            len(trace["traceEvents"]),
            sum(1 for s in sources if s["events"]), output)
    else:
        click.echo(json.dumps(trace, indent=1))


@cluster_trace.command(name="summary")
@_conf_dir_opt
@click.option("--trace-id", default=None,
              help="Only this trace.")
def cluster_trace_summary(conf_dir, trace_id):
    """Per-trace span counts, node lanes, and wall extents."""
    collector = _trace_collector(conf_dir)
    rows = collector.summary()
    if trace_id:
        rows = [r for r in rows if r["trace_id"] == trace_id]
    if not rows:
        cli_logger.info("No traces collected.")
        return
    click.echo(f"{'trace':<34}  {'spans':>5}  {'nodes':>5}  "
               f"{'duration':>10}  root")
    for row in rows:
        click.echo(
            f"{row['trace_id']:<34}  {row['spans']:>5}  "
            f"{len(row['nodes']):>5}  "
            f"{row['duration_s'] * 1e3:>8.2f}ms  {row['root']}")


# ----------------------------------------------------------------- events --

@cli.group(name="events")
def events_group():
    """Flight recorder: the durable JSONL journal of control-plane
    decisions (docs/observability.md).  Each record carries the
    traceparent active when it was written, linking the WHY to the
    distributed trace of the operation."""


_events_path_opt = click.option(
    "--path", default=None,
    help="Journal path (default: <tik home>/logs/events.jsonl).")


def _format_event(record):
    import datetime as _dt
    ts = _dt.datetime.fromtimestamp(record.get("ts", 0)).strftime(
        "%Y-%m-%d %H:%M:%S.%f")[:-3]
    name = record.get("name", "?")
    extras = " ".join(
        f"{k}={v}" for k, v in record.items()
        if k not in ("ts", "seq", "name"))
    return f"{ts}  {name}  {extras}".rstrip()


@events_group.command(name="dump")
@_events_path_opt
@click.option("--json", "as_json", is_flag=True,
              help="Emit raw records as a JSON array.")
@click.option("--trace-id", default=None,
              help="Only events stamped with this trace.")
def events_dump(path, as_json, trace_id):
    """Replay the journal, causally ordered (torn lines skipped)."""
    from cloudtik_tpu_torch.telemetry import events as tevents
    records = tevents.read_events(path)
    if trace_id:
        records = [r for r in records
                   if trace_id in r.get("traceparent", "")]
    records.sort(key=lambda r: r.get("ts", 0))
    if as_json:
        click.echo(json.dumps(records, indent=1, default=str))
        return
    if not records:
        cli_logger.info("No events recorded.")
        return
    for record in records:
        click.echo(_format_event(record))


@events_group.command(name="tail")
@_events_path_opt
@click.option("--lines", "-n", default=10, show_default=True)
@click.option("--follow", "-f", is_flag=True,
              help="Keep streaming appended events.")
def events_tail(path, lines, follow):
    """Show the newest journal events; -f follows appends."""
    import time as _time

    from cloudtik_tpu_torch.telemetry import events as tevents
    records = tevents.read_events(path)
    for record in records[-lines:]:
        click.echo(_format_event(record))
    if not follow:
        return
    files = tevents.journal_files(path)
    offset = os.path.getsize(files[-1]) if files else 0
    try:
        while True:
            _time.sleep(0.5)
            files = tevents.journal_files(path)
            if not files:
                continue
            current = files[-1]
            size = os.path.getsize(current)
            if size < offset:        # rotated under us
                offset = 0
            if size == offset:
                continue
            with open(current, "rb") as f:
                f.seek(offset)
                chunk = f.read()
            # only complete lines: the tail may be mid-append
            complete, _, _rest = chunk.rpartition(b"\n")
            offset += len(complete) + 1 if complete else 0
            for line in complete.splitlines():
                try:
                    click.echo(_format_event(json.loads(line)))
                except ValueError:
                    continue
    except KeyboardInterrupt:
        pass


# ------------------------------------------------------------------ serve --

@cli.group(name="serve")
def serve_group():
    """Serving observability: the request-lifecycle ledger and the
    router decision ledger (docs/observability.md "Request ledger" /
    "Request forensics").  Engines append one durable JSONL record per
    finished request, the router one per routed request; these verbs
    replay them — offline percentiles/availability (`requests`),
    fleet membership (`replicas`), and one request's stitched
    cross-replica story (`explain`)."""


@serve_group.command(name="requests")
@click.option("--path", "paths", multiple=True,
              help="Ledger path (default: <tik home>/logs/"
                   "serve-requests.jsonl; TIK_REQLOG_PATH overrides). "
                   "Repeat for multiple replicas' ledgers — the "
                   "populations merge into one fleet view.")
@click.option("--fleet", "as_fleet", is_flag=True,
              help="With --stats: add a per-replica breakdown after "
                   "the merged population (shorthand for running "
                   "--by replica alongside the overall stats).")
@click.option("--tail", "tail_n", type=int, default=None,
              help="Only the newest N records.")
@click.option("--since", "since_s", type=float, default=None,
              help="Only records finished in the last N seconds.")
@click.option("--finish", "finish_filter", default=None,
              type=click.Choice(["done", "cancelled", "rejected",
                                 "error", "drained", "migrated"]),
              help="Only records with this finish reason.")
@click.option("--stats", "as_stats", is_flag=True,
              help="Offline p50/p95/p99 (TTFT/TPOT/queue wait + the "
                   "five lifecycle phases) and availability over the "
                   "selected records.")
@click.option("--by", "group_by", default=None,
              type=click.Choice(["tenant", "adapter_id", "path",
                                 "replica"]),
              help="With --stats: one stats block per group — "
                   "per-tenant (who burns whose budget), per fabric "
                   "path (is the migrated path earning its wire "
                   "cost), or per replica (is one replica dragging "
                   "the fleet tail).")
@click.option("--json", "as_json", is_flag=True,
              help="Emit raw records (or the stats dict) as JSON.")
def serve_requests(paths, as_fleet, tail_n, since_s, finish_filter,
                   as_stats, group_by, as_json):
    """Replay the request ledger (torn final line skipped)."""
    import time as _time

    from cloudtik_tpu_torch.serve import explain as sexplain
    from cloudtik_tpu_torch.serve import reqlog
    if paths:
        records = sexplain.fleet_requests(paths)
    else:
        records = reqlog.read_requests(None)
    if finish_filter:
        records = [r for r in records
                   if r.get("finish") == finish_filter]
    if since_s is not None:
        cutoff = _time.time() - since_s
        records = [r for r in records
                   if (r.get("done_ts") or r.get("ts") or 0) >= cutoff]
    records.sort(key=lambda r: r.get("done_ts") or r.get("ts") or 0)
    if tail_n is not None:
        records = records[-tail_n:]
    if group_by and not as_stats:
        raise click.UsageError("--by requires --stats")

    def _print_stats(stats):
        availability = stats["availability"]
        avail_s = f"{availability * 100:.2f}%" \
            if availability is not None else "-"
        click.echo(f"requests: {stats['count']}   "
                   f"availability: {avail_s}")
        for reason, count in stats["finish"].items():
            click.echo(f"  {reason:<12} {count}")
        click.echo(f"{'latency':<12} {'count':>7} {'p50':>10} "
                   f"{'p95':>10} {'p99':>10}")
        def _ms(v):
            return f"{v * 1e3:>8.2f}ms" if v is not None else \
                f"{'-':>10}"

        for field, label in (("ttft_s", "ttft"),
                             ("queue_wait_s", "queue_wait"),
                             ("tpot_s", "tpot")):
            entry = stats[field]
            click.echo(f"{label:<12} {entry['count']:>7} "
                       f"{_ms(entry['p50'])} {_ms(entry['p95'])} "
                       f"{_ms(entry['p99'])}")
        # the five-phase TTFT decomposition (rows appear once any
        # record in the population carried the phase — fabric-only
        # phases stay hidden on a monolithic fleet)
        for field in reqlog.PHASE_FIELDS:
            entry = stats.get(field)
            if not entry or not entry["count"]:
                continue
            label = "ph:" + field[: -len("_s")]
            click.echo(f"{label:<12} {entry['count']:>7} "
                       f"{_ms(entry['p50'])} {_ms(entry['p95'])} "
                       f"{_ms(entry['p99'])}")
        if stats.get("migrations"):
            click.echo(
                f"migration: imports {stats['migrations']}  "
                f"tokens {stats['migrated_tokens']}  "
                f"(KV moved between engines instead of recomputed)")
        if stats.get("spec_steps"):
            rate = stats.get("spec_acceptance_rate")
            rate_s = f"{rate * 100:.1f}%" if rate is not None else "-"
            tpv = stats.get("spec_tokens_per_verify")
            tpv_s = f"{tpv:.2f}" if tpv is not None else "-"
            click.echo(
                f"spec: verify_steps {stats['spec_steps']}  "
                f"draft {stats['draft_tokens']}  "
                f"accepted {stats['accepted_tokens']}  "
                f"acceptance {rate_s}  tokens/verify {tpv_s}")

    if as_stats:
        if group_by:
            grouped = reqlog.group_stats(records, by=group_by)
            if as_json:
                click.echo(json.dumps(grouped, indent=1))
                return
            for key, stats in grouped.items():
                click.echo(f"--- {group_by}: {key} ---")
                _print_stats(stats)
            return
        stats = reqlog.compute_stats(records)
        if as_fleet:
            per_replica = reqlog.group_stats(records, by="replica")
            if as_json:
                click.echo(json.dumps(
                    {"fleet": stats, "replicas": per_replica},
                    indent=1))
                return
            click.echo(f"--- fleet ({len(paths) or 1} source"
                       f"{'s' if len(paths) != 1 else ''}) ---")
            _print_stats(stats)
            for key, rstats in per_replica.items():
                click.echo(f"--- replica: {key} ---")
                _print_stats(rstats)
            return
        if as_json:
            click.echo(json.dumps(stats, indent=1))
            return
        _print_stats(stats)
        return
    if as_json:
        click.echo(json.dumps(records, indent=1, default=str))
        return
    if not records:
        cli_logger.info("No request records (is a serving daemon "
                        "running with the ledger installed?).")
        return
    import datetime as _dt
    for record in records:
        ts = _dt.datetime.fromtimestamp(
            record.get("done_ts") or record.get("ts") or 0).strftime(
            "%Y-%m-%d %H:%M:%S.%f")[:-3]

        def _fmt_ms(key):
            value = record.get(key)
            return f"{value * 1e3:.1f}ms" \
                if isinstance(value, (int, float)) else "-"

        replica = record.get("replica")
        where = f"{replica}#" if replica else "#"
        click.echo(
            f"{ts}  {where}{record.get('request_id', '?'):<6} "
            f"{record.get('finish', '?'):<10} "
            f"prompt={record.get('prompt_tokens', '?'):<4} "
            f"out={record.get('output_tokens', '?'):<4} "
            f"queue={_fmt_ms('queue_wait_s')} "
            f"ttft={_fmt_ms('ttft_s')} tpot={_fmt_ms('tpot_s')}")


@serve_group.command(name="replicas")
@click.option("--url", required=True,
              help="Router base URL (e.g. http://head:8210) — reads "
                   "GET /v1/replicas.")
@click.option("--json", "as_json", is_flag=True,
              help="Emit the raw registry view as JSON.")
def serve_replicas(url, as_json):
    """The serving fabric's replica registry + live router load:
    who is routable, who is draining/condemned, per-replica in-flight
    counts, and the autoscaler's current target."""
    import urllib.request
    with urllib.request.urlopen(
            url.rstrip("/") + "/v1/replicas", timeout=10) as resp:
        view = json.loads(resp.read().decode())
    if as_json:
        click.echo(json.dumps(view, indent=1))
        return
    target = view.get("target_replicas")
    click.echo(f"policy: {view.get('policy', '?')}"
               + (f"   target replicas: {target}"
                  if target is not None else ""))
    click.echo(f"{'replica':<14} {'role':<8} {'version':<8} "
               f"{'state':<22} {'beat age':>9} {'inflight':>9} "
               f"{'queue':>6} {'slots':>6}")
    for rep in view.get("replicas", []):
        if rep.get("condemned"):
            state = f"condemned:{rep['condemned']}"
        elif rep.get("draining"):
            state = "draining"
        elif rep.get("routable"):
            state = "routable"
        else:
            state = "dead (beat aged out)"
        stats = rep.get("stats") or {}
        click.echo(
            f"{rep.get('replica_id', '?'):<14} "
            f"{rep.get('role', '?'):<8} "
            f"{rep.get('version', '0'):<8} {state:<22} "
            f"{rep.get('beat_age_s', '?'):>8}s "
            f"{rep.get('inflight', 0):>9} "
            f"{stats.get('queue_depth', '-'):>6} "
            f"{rep.get('slots', '-'):>6}")


@serve_group.command(name="explain")
@click.argument("request_id")
@click.option("--path", "router_path", default=None,
              help="Router decision ledger path (default: <tik home>/"
                   "logs/serve-router.jsonl; TIK_ROUTER_LOG_PATH "
                   "overrides).")
@click.option("--reqlog", "reqlog_paths", multiple=True,
              help="Replica request-ledger path(s) to stitch in "
                   "(repeat per replica; default: the local default "
                   "ledger).")
@click.option("--url", default=None,
              help="Ask a running router instead of reading local "
                   "files (GET /v1/explain — router-ledger view only; "
                   "replica phase records need --reqlog files).")
@click.option("--trace", "trace_file", default=None,
              type=click.Path(exists=True),
              help="A Chrome-trace export (tik cluster trace export) "
                   "to narrow to this request's trace id.")
@click.option("--trace-out", default=None,
              help="Write the narrowed Chrome trace here (default: "
                   "explain-<request_id>.trace.json).")
@click.option("--json", "as_json", is_flag=True,
              help="Emit the stitched structure as JSON.")
def serve_explain(request_id, router_path, reqlog_paths, url,
                  trace_file, trace_out, as_json):
    """Why did request N behave the way it did?

    One timeline from the router's decision ledger (which replica and
    WHY, hop by hop) joined with every replica's request ledger
    (phases: router_wait -> prefill -> handoff_wire -> decode_first ->
    decode_rest, critical path flagged) — the forensics half of
    `tik slo status` (docs/observability.md "Request forensics")."""
    from cloudtik_tpu_torch.serve import explain as sexplain
    if url:
        import urllib.request
        with urllib.request.urlopen(
                url.rstrip("/") + "/v1/explain?request_id="
                + str(request_id), timeout=10) as resp:
            result = json.loads(resp.read().decode())
    else:
        routes, requests = sexplain.load(router_path, reqlog_paths)
        result = sexplain.build(request_id, routes, requests)
    if as_json:
        click.echo(json.dumps(result, indent=1, default=str))
    else:
        click.echo(sexplain.render(result))
    if trace_file:
        traceparent = None
        if result.get("route"):
            traceparent = result["route"].get("traceparent")
        if traceparent is None:
            for rec in result.get("records") or []:
                if rec.get("traceparent"):
                    traceparent = rec["traceparent"]
                    break
        with open(trace_file) as f:
            trace = json.load(f)
        narrowed = sexplain.filter_trace(trace, traceparent)
        out_path = trace_out or f"explain-{request_id}.trace.json"
        with open(out_path, "w") as f:
            json.dump(narrowed, f)
        cli_logger.info(
            "Wrote {} span(s) on this request's trace to {}",
            len(narrowed["traceEvents"]), out_path)


# ------------------------------------------------------------------ chaos --

@cli.group()
def chaos():
    """Deterministic fault-injection drills (docs/fault-injection.md).

    Plans are seeded YAML schedules of faults fired at injection seams
    threaded through the control plane, trainer, and serve engine; with
    no plan armed every seam is a single-attribute-check no-op."""


@chaos.command(name="validate")
@click.argument("plan_file", type=click.Path(exists=True))
def chaos_validate(plan_file):
    """Parse and schema-check a fault plan."""
    from cloudtik_tpu_torch.faults.chaos import validate_plan
    try:
        spec = validate_plan(plan_file)
    except Exception as e:  # bad YAML, wrong shape, unknown kinds, ...
        cli_logger.abort("Invalid fault plan: {}", e)
    click.echo(json.dumps(spec, indent=2))
    cli_logger.success("Plan is valid ({} fault point(s)).",
                       len(spec["faults"]))


@chaos.command(name="run")
@click.argument("plan_file", type=click.Path(exists=True))
@click.option("--config", "config_file", required=True,
              type=click.Path(exists=True),
              help="Cluster config to drill (virtual/mock providers).")
@click.option("--passes", default=5, show_default=True,
              help="Scaler reconciliation passes to drive.")
@click.option("--interval", default=0.5, show_default=True,
              help="Seconds between passes.")
@click.option("--json", "as_json", is_flag=True,
              help="Emit the full result as JSON.")
def chaos_run(plan_file, config_file, passes, interval, as_json):
    """Arm PLAN_FILE and drive scaler passes against a virtual cluster.

    The plan's injection trace is printed afterwards — same seed, same
    cluster, same trace."""
    from cloudtik_tpu_torch.faults.chaos import format_trace, run_drill
    from cloudtik_tpu_torch.faults.plan import load_plan
    config = _load(config_file)
    provider_type = config.get("provider", {}).get("type", "")
    if provider_type not in ("virtual", "mock", "onpremise"):
        cli_logger.abort(
            "chaos run only drills virtual/mock clusters (got provider "
            "{}); arm real clusters explicitly via TIK_FAULT_PLAN.",
            provider_type)
    plan = load_plan(plan_file)
    result = run_drill(config, plan, passes=passes, interval_s=interval)
    if as_json:
        click.echo(json.dumps(result, indent=2, default=str))
        return
    cli_logger.print("Injection trace ({} fault(s) fired):",
                     len(result["trace"]))
    click.echo(format_trace(result))
    if result["errors"]:
        cli_logger.print("Surfaced errors: {}", result["errors"])
    summary = result["summary"]
    cli_logger.print(
        "Post-drill: {} worker(s), pending launches {}.",
        summary["num_workers"], summary["pending_launches"])


def main():
    from cloudtik_tpu_torch.control.executor.base import CommandError
    try:
        return cli(standalone_mode=True)
    except CommandError as e:
        cli_logger.error("Command failed (exit {}).", e.returncode)
        sys.exit(e.returncode or 1)
    except (RuntimeError, ValueError, KeyError, TimeoutError) as e:
        cli_logger.error("Error: {}", e)
        sys.exit(1)


if __name__ == "__main__":
    main()
