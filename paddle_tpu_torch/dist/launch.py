"""The launcher (ref: ``python/paddle/distributed/launch.py``): the
counterpart of ``paddle_tpu/dist/launch.py``.

``python -m paddle_tpu_torch.dist.launch --nproc_per_node=N script.py
args`` starts one process a rank of this node, each with the reference's
environment (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``), which
``dist.init_parallel_env`` reads: the ranks meet at the first endpoint.
Endpoints are ``<ip>:<started_port + i>`` over ``--ips``, hosts first.
With ``--run_dir`` every rank journals into its own
``<run_dir>/rank_NN`` with its rank as ``PADDLE_TPU_RANK``.

Failure semantics are the reference's (``launch.py:15-19``): when a
worker exits non-zero, the others are terminated (SIGTERM, then SIGKILL
after a shared 10 s) and that first code is the launcher's; a death by
signal ``s`` is ``128 + s``. ``--elastic`` (the gang supervisor) waits
for ROADMAP Queue 1 item 6d and raises.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from .utils import exit_code, get_cluster, terminate_local_procs, \
    trainer_env

__all__ = ["launch", "get_cluster_endpoints", "get_gpus",
           "get_cluster_from_args"]


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.dist.launch")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="trainer processes on this host")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated host list")
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")))
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--elastic", action="store_true",
                   help="supervise the gang elastically (not ported: "
                        "ROADMAP Queue 1 item 6d)")
    p.add_argument("--run_dir", type=str,
                   default=os.environ.get("PADDLE_TPU_RUN_DIR") or None,
                   help="journal root: each rank journals into "
                        "<run_dir>/rank_NN")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def get_cluster_endpoints(ips, nproc_per_node, started_port):
    """Every trainer endpoint, hosts first (ref: get_cluster_from_args)."""
    eps = []
    for ip in ips.split(","):
        for i in range(nproc_per_node):
            eps.append(f"{ip}:{started_port + i}")
    return eps


def _trainer_env(args, eps, local, run_dir=None):
    """The environment update of local worker ``local``."""
    rank = args.node_rank * args.nproc_per_node + local
    env = trainer_env(rank, len(eps), eps)
    if run_dir:
        from ..obs.journal import RANK_ENV, rank_subdir

        env["PADDLE_TPU_RUN_DIR"] = os.path.join(run_dir,
                                                 rank_subdir(rank))
        env[RANK_ENV] = str(rank)
    return env


def _wait_gang(procs):
    """Wait for every worker; at the first non-zero exit terminate the
    rest and return that worker's code as a shell reports it."""
    try:
        while True:
            for p, _ in procs:
                rc = p.poll()
                if rc is not None and rc != 0:
                    terminate_local_procs([q for q, _ in procs
                                           if q is not p])
                    return exit_code(rc)
            if all(p.poll() is not None for p, _ in procs):
                return 0
            time.sleep(0.05)
    finally:
        for _, out in procs:
            if out:
                out.close()


def launch(args=None):
    """Start this node's workers and wait for them; returns the exit
    code."""
    args = args or _parse_args()
    if getattr(args, "elastic", False):
        raise NotImplementedError(
            "launch --elastic (the gang supervisor) waits for ROADMAP "
            "Queue 1 item 6d")
    eps = get_cluster_endpoints(args.ips, args.nproc_per_node,
                                args.started_port)
    cmd = [sys.executable, args.training_script] + \
        args.training_script_args
    procs = []
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    try:
        for local in range(args.nproc_per_node):
            rank = args.node_rank * args.nproc_per_node + local
            env = dict(os.environ)
            env.update(_trainer_env(args, eps, local,
                                    run_dir=getattr(args, "run_dir", None)))
            out = None
            if args.log_dir:
                out = open(os.path.join(args.log_dir,
                                        f"worker.{rank}.log"), "w")
            procs.append((subprocess.Popen(
                cmd, env=env, stdout=out,
                stderr=subprocess.STDOUT if out else None), out))
    except BaseException:
        terminate_local_procs([p for p, _ in procs])
        raise
    return _wait_gang(procs)


def get_gpus(selected_gpus):
    """ref: launch.py get_gpus: the selected cards against
    ``CUDA_VISIBLE_DEVICES``; None takes every visible card."""
    visible = os.getenv("CUDA_VISIBLE_DEVICES")
    if selected_gpus is None or selected_gpus == "":
        if visible:
            return list(range(len(visible.split(","))))
        import torch

        return list(range(torch.cuda.device_count()))
    sel = [s.strip() for s in str(selected_gpus).split(",") if s.strip()]
    if not visible:
        return [int(s) for s in sel]
    vis = [v.strip() for v in visible.split(",")]
    for s in sel:
        if s not in vis:
            raise ValueError(
                f"selected device {s} not in visible devices {vis}")
    return [vis.index(s) for s in sel]


def get_cluster_from_args(args, selected_gpus):
    """ref: launch.py get_cluster_from_args: Cluster/Pod from parsed
    arguments (``--ips`` or the reference's ``cluster_node_ips`` and
    ``node_ip``)."""
    ips_arg = getattr(args, "ips", None) or \
        getattr(args, "cluster_node_ips", None)
    if ips_arg is None:
        raise ValueError("args carries neither 'ips' nor "
                         "'cluster_node_ips'")
    node_ips = [ip.strip() for ip in str(ips_arg).split(",")]
    node_ip = getattr(args, "node_ip", None)
    if node_ip is None:
        rank = getattr(args, "node_rank", 0) or 0
        node_ip = node_ips[int(rank)]
    if node_ip not in node_ips:
        raise ValueError(
            f"this node's ip {node_ip!r} is not in the node list "
            f"{node_ips} (check --node_ip / --ips)")
    started = int(getattr(args, "started_port", 6170) or 6170)
    sel = get_gpus(None) if selected_gpus is None else list(selected_gpus)
    ports = [started + i for i in range(len(sel))]
    return get_cluster(node_ips, node_ip, ports, sel)


if __name__ == "__main__":
    sys.exit(launch())
