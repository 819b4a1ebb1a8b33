"""The PaddleCloud environment's cluster: this package's copy of
``paddle_tpu/dist/cloud_utils.py`` (ref: ``python/paddle/distributed/
cloud_utils.py``), the Cluster model from the ``PADDLE_TRAINERS`` /
``POD_IP`` variables a cloud scheduler sets.
"""
from __future__ import annotations

import os

from .utils import get_cluster, logger

__all__ = ["get_cloud_cluster", "get_trainers_num"]


def get_cloud_cluster(args_node_ips=None, args_node_ip=None,
                      args_port=6170, selected_gpus=None):
    """ref: cloud_utils.py:21 — the environment wins over the
    arguments."""
    env_ips = os.getenv("PADDLE_TRAINERS")
    if env_ips:
        node_ips = env_ips.split(",")
        node_ip = os.getenv("POD_IP", args_node_ip)
        if node_ip is None:
            if len(node_ips) > 1:
                raise ValueError(
                    "multi-node PADDLE_TRAINERS is set but neither "
                    "POD_IP nor --node_ip identifies THIS node — "
                    "defaulting would give every node rank 0")
            node_ip = node_ips[0]
        if args_node_ips and isinstance(args_node_ips, str) and \
                args_node_ips != "127.0.0.1" and \
                args_node_ips != env_ips:
            logger.warning(
                "PADDLE_TRAINERS from the cloud environment overrides "
                "--cluster_node_ips")
    else:
        node_ips = (args_node_ips.split(",")
                    if isinstance(args_node_ips, str)
                    else list(args_node_ips or ["127.0.0.1"]))
        node_ip = args_node_ip or node_ips[0]
    if node_ip not in node_ips:
        raise ValueError(
            f"this node's ip {node_ip!r} is not in the trainer node "
            f"list {node_ips} (check POD_IP / --node_ip)")
    selected = list(selected_gpus or [0])
    started_port = int(os.getenv("PADDLE_PORT", args_port))
    ports = [started_port + i for i in range(len(selected))]
    return get_cluster(node_ips, node_ip, ports, selected)


def get_trainers_num():
    return int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
