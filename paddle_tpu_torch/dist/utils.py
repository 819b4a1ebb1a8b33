"""The cluster model and the local trainer processes: this package's copy
of ``paddle_tpu/dist/utils.py`` (ref: ``python/paddle/distributed/
utils.py``), plus the reference's ``start_local_trainers`` and
``watch_local_trainers``.

``Cluster``/``Pod``/``Trainer`` describe a launch's ranks, endpoints and
cards ("gpus" keeps the reference's field name). ``start_local_trainers``
starts one process a trainer of a pod with the ``PADDLE_TRAINER_*``
environment ``dist.init_parallel_env`` reads; ``watch_local_trainers``
polls them and, when one has failed, terminates the rest and raises.
"""
from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import time
from contextlib import closing

__all__ = [
    "Hdfs", "Cluster", "JobServer", "Trainer", "Pod", "TrainerProc",
    "get_logger", "get_cluster", "terminate_local_procs",
    "get_host_name_ip", "add_arguments", "find_free_ports",
    "start_local_trainers", "watch_local_trainers", "exit_code",
    "trainer_env",
]

logger = logging.getLogger(__name__)


def get_logger(log_level=20, name="root"):
    log = logging.getLogger(name)
    log.setLevel(log_level)
    return log


class Hdfs:
    """ref: utils.py Hdfs — checkpoint filesystem coordinates."""

    def __init__(self):
        self.hdfs_ugi = None
        self.hdfs_name = None
        self.hdfs_path = None

    def is_valid(self):
        return (self.hdfs_ugi is not None and self.hdfs_name is not None
                and self.hdfs_path is not None)

    def __str__(self):
        return (f"hdfs_ugi:{self.hdfs_ugi} hdfs_name:{self.hdfs_name} "
                f"hdfs_path:{self.hdfs_path}")

    def __eq__(self, n):
        if not isinstance(n, Hdfs):
            return NotImplemented
        return (self.hdfs_ugi == n.hdfs_ugi
                and self.hdfs_name == n.hdfs_name
                and self.hdfs_path == n.hdfs_path)

    def __ne__(self, n):
        return not self == n


class JobServer:
    def __init__(self):
        self.endpoint = None

    def __str__(self):
        return f"{self.endpoint}"

    def __eq__(self, j):
        if not isinstance(j, JobServer):
            return NotImplemented
        return self.endpoint == j.endpoint

    def __ne__(self, j):
        return not self == j


class Trainer:
    def __init__(self):
        self.gpus = []          # card indices (ref field name)
        self.endpoint = None
        self.rank = None

    def __str__(self):
        return (f"gpu:{self.gpus} endpoint:{self.endpoint} "
                f"rank:{self.rank}")

    def __eq__(self, t):
        if not isinstance(t, Trainer):
            return NotImplemented
        return (self.gpus == t.gpus and self.endpoint == t.endpoint
                and self.rank == t.rank)

    def __ne__(self, t):
        return not self == t

    def rank_(self):
        return self.rank


class Pod:
    """One node's worth of trainers."""

    def __init__(self):
        self.rank = None
        self.id = None
        self.addr = None
        self.port = None
        self.trainers = []
        self.servers = []
        self.gpus = []

    def __str__(self):
        return (f"rank:{self.rank} id:{self.id} addr:{self.addr} "
                f"port:{self.port} trainers:"
                f"{[str(t) for t in self.trainers]}")

    def __eq__(self, pod):
        if not isinstance(pod, Pod):
            return NotImplemented
        if (self.rank != pod.rank or self.id != pod.id
                or self.addr != pod.addr or self.port != pod.port
                or len(self.trainers) != len(pod.trainers)):
            return False
        return all(a == b for a, b in zip(self.trainers, pod.trainers))

    def __ne__(self, pod):
        return not self == pod

    def parse_response(self, res_pods):
        pass

    def get_visible_gpus(self):
        return ",".join(str(g) for t in self.trainers for g in t.gpus)


class Cluster:
    def __init__(self, hdfs=None):
        self.job_server = None
        self.pods = []
        self.hdfs = hdfs
        self.job_stage_flag = None

    def __str__(self):
        return (f"job_server:{self.job_server} "
                f"pods:{[str(p) for p in self.pods]} "
                f"job_stage_flag:{self.job_stage_flag} hdfs:{self.hdfs}")

    def __eq__(self, cluster):
        if not isinstance(cluster, Cluster):
            return NotImplemented
        if len(self.pods) != len(cluster.pods):
            return False
        return all(a == b for a, b in zip(self.pods, cluster.pods))

    def __ne__(self, cluster):
        return not self == cluster

    def update_pods(self, cluster):
        self.pods = list(cluster.pods)

    def trainers_nranks(self):
        return len(self.trainers_endpoints())

    def pods_nranks(self):
        return len(self.pods)

    def trainers_endpoints(self):
        return [t.endpoint for p in self.pods for t in p.trainers]

    def pods_endpoints(self):
        return [f"{p.addr}:{p.port}" for p in self.pods]

    def get_pod_by_id(self, pod_id):
        for p in self.pods:
            if str(p.id) == str(pod_id):
                return p
        return None


def get_cluster(node_ips, node_ip, paddle_ports, selected_gpus):
    """The Cluster/Pod model of a node list (ref: utils.py:230): one
    trainer a selected card on every node; returns ``(cluster, this
    node's pod)``."""
    if not isinstance(paddle_ports, list):
        raise TypeError("paddle_ports must be a list")
    if len(paddle_ports) < len(selected_gpus):
        raise ValueError(
            f"need one port per trainer: {len(paddle_ports)} ports for "
            f"{len(selected_gpus)} trainers")
    cluster = Cluster(hdfs=None)
    trainer_rank = 0
    for node_rank, ip in enumerate(node_ips):
        pod = Pod()
        pod.rank = node_rank
        pod.addr = ip
        pod.id = node_rank
        for i, gpu in enumerate(selected_gpus):
            trainer = Trainer()
            trainer.gpus.append(gpu)
            trainer.endpoint = f"{ip}:{paddle_ports[i]}"
            trainer.rank = trainer_rank
            trainer_rank += 1
            pod.trainers.append(trainer)
        cluster.pods.append(pod)
    pod_rank = node_ips.index(node_ip)
    return cluster, cluster.pods[pod_rank]


class TrainerProc:
    def __init__(self):
        self.proc = None
        self.log_fn = None
        self.log_offset = None
        self.rank = None
        self.local_rank = None
        self.cmd = None


def exit_code(rc):
    """A child's return code as a shell reports it: a death by signal
    ``s`` (``-s`` from ``subprocess``) is ``128 + s``."""
    return 128 - rc if rc < 0 else rc


def terminate_local_procs(procs):
    """SIGTERM, one shared 10 s deadline, then SIGKILL; reap and close
    logs."""
    live = []
    for p in procs:
        proc = getattr(p, "proc", p)
        if proc is None:
            continue
        if proc.poll() is None:
            proc.terminate()
        live.append((p, proc))
    deadline = time.time() + 10
    for p, proc in live:
        try:
            proc.wait(timeout=max(0.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log_fn = getattr(p, "log_fn", None)
        if log_fn is not None and hasattr(log_fn, "close"):
            log_fn.close()


def get_host_name_ip():
    try:
        host_name = socket.gethostname()
        return host_name, socket.gethostbyname(host_name)
    except OSError:
        return None


def add_arguments(argname, type, default, help, argparser, **kwargs):
    """ref: utils.py add_arguments — argparse helper with bool support."""
    if type is bool:
        def type(v):  # noqa: A001
            return str(v).lower() in ("true", "1", "yes")
    argparser.add_argument("--" + argname, default=default, type=type,
                           help=f"{help} Default: %(default)s.", **kwargs)


def find_free_ports(num):
    """``num`` distinct currently free TCP ports on this host."""
    ports = set()
    for _ in range(num * 50):
        with closing(socket.socket(socket.AF_INET,
                                   socket.SOCK_STREAM)) as s:
            s.bind(("127.0.0.1", 0))
            ports.add(s.getsockname()[1])
        if len(ports) >= num:
            return set(list(ports)[:num])
    return None


def trainer_env(rank, world, endpoints):
    """The ``PADDLE_TRAINER_*`` variables of one trainer."""
    return {"PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank]}


def start_local_trainers(cluster, pod, training_script,
                         training_script_args, log_dir=None, env=None):
    """One process a trainer of ``pod`` (ref: utils.py
    ``start_local_trainers``): ``python -u training_script args`` with
    ``FLAGS_selected_gpus`` and the ``PADDLE_TRAINER_*`` variables on top
    of ``env`` (default this process's). Returns the ``TrainerProc``s."""
    eps = cluster.trainers_endpoints()
    procs = []
    for local, t in enumerate(pod.trainers):
        penv = dict(os.environ if env is None else env)
        penv.update(trainer_env(t.rank, len(eps), eps))
        penv["FLAGS_selected_gpus"] = ",".join(str(g) for g in t.gpus)
        cmd = [sys.executable, "-u", training_script] + \
            list(training_script_args)
        fn = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            fn = open(os.path.join(log_dir, f"workerlog.{local}"), "a")
        tp = TrainerProc()
        tp.proc = subprocess.Popen(cmd, env=penv, stdout=fn,
                                   stderr=subprocess.STDOUT if fn else None)
        tp.rank, tp.local_rank, tp.log_fn, tp.cmd = t.rank, local, fn, cmd
        procs.append(tp)
    return procs


def watch_local_trainers(procs, nranks):
    """Poll the trainers once: True while any runs, False when all ended
    with 0. A trainer that ended otherwise has the rest terminated and
    raises ``RuntimeError`` naming its rank and shell exit code (ref:
    utils.py ``watch_local_trainers``)."""
    alive = False
    for p in procs:
        rc = p.proc.poll()
        if rc is None:
            alive = True
        elif rc != 0:
            terminate_local_procs([q for q in procs if q is not p])
            raise RuntimeError(
                f"trainer rank {p.rank} of {nranks} exited with code "
                f"{exit_code(rc)}")
    return alive
