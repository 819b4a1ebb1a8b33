"""paddle_tpu_torch's launcher, cluster model and process environment
against the JAX package's, on the CPU.

The launcher starts small Python scripts that import nothing of either
package (each starts in a fraction of a second): the ranks' environment
(the JAX launcher's ``PADDLE_TRAINER_*`` variables, the per-rank journal
directories), the failure semantics of ``launch.py:15-19`` (the first
non-zero exit code is the launcher's, a death by signal ``128 + s``, the
survivors terminated within the shared 10 s deadline) and ``--elastic``
refused as waiting for item 6d. ``Cluster``/``Pod`` from node lists and
from the cloud environment against the JAX package's ``dist/utils.py``
and ``cloud_utils.py``; ``start_local_trainers`` and
``watch_local_trainers``; ``init_mesh``'s checks; the backend rule.
"""
import json
import os
import signal
import sys
import time

import pytest
import torch

import jax

from paddle_tpu.dist import cloud_utils as jcloud
from paddle_tpu.dist import env as jenv
from paddle_tpu.dist import launch as jlaunch
from paddle_tpu.dist import utils as jutils
from paddle_tpu_torch import _device
from paddle_tpu_torch.dist import cloud_utils, env, launch, utils
from paddle_tpu_torch.obs.journal import rank_subdir

from torch_test_threads import torch_threads  # noqa: F401,E402

ENV_SCRIPT = """
import json, os, sys
keys = [k for k in os.environ if k.startswith(("PADDLE_", "FLAGS_"))]
with open(os.path.join(sys.argv[1],
          "rank_%s.json" % os.environ["PADDLE_TRAINER_ID"]), "w") as f:
    json.dump({k: os.environ[k] for k in keys}, f)
"""

FAIL_SCRIPT = """
import os, signal, sys, time
rank = int(os.environ["PADDLE_TRAINER_ID"])
with open(os.path.join(sys.argv[1], "pid_%d" % rank), "w") as f:
    f.write(str(os.getpid()))
if rank == 1:
    time.sleep(0.5)
    if sys.argv[2] == "signal":
        os.kill(os.getpid(), signal.SIGKILL)
    sys.exit(int(sys.argv[2]))
time.sleep(120)
"""


def _script(tmp_path, text):
    p = tmp_path / "script.py"
    p.write_text(text)
    return str(p)


def test_launch_sets_each_ranks_environment(tmp_path):
    script = _script(tmp_path, ENV_SCRIPT)
    args = launch._parse_args(["--nproc_per_node=2", "--started_port=7100",
                               "--run_dir", str(tmp_path / "run"), script,
                               str(tmp_path)])
    assert launch.launch(args) == 0
    jargs = jlaunch._parse_args(["--nproc_per_node=2",
                                 "--started_port=7100", script])
    eps = jlaunch.get_cluster_endpoints("127.0.0.1", 2, 7100)
    assert launch.get_cluster_endpoints("127.0.0.1", 2, 7100) == eps
    for r in range(2):
        got = json.loads((tmp_path / f"rank_{r}.json").read_text())
        want = jlaunch._trainer_env(jargs, eps, 2, r)
        for k, v in want.items():
            if k.startswith("PADDLE_TRAINER") or k == \
                    "PADDLE_CURRENT_ENDPOINT":
                assert got[k] == v, k
        assert got["PADDLE_TPU_RUN_DIR"] == os.path.join(
            str(tmp_path / "run"), rank_subdir(r))
        assert got["PADDLE_TPU_RANK"] == str(r)


@pytest.mark.parametrize("how,code", [("3", 3), ("signal", 128 + 9)])
def test_first_failure_is_propagated_and_survivors_end(tmp_path, how, code):
    script = _script(tmp_path, FAIL_SCRIPT)
    args = launch._parse_args(["--nproc_per_node=2", script, str(tmp_path),
                               how])
    t0 = time.perf_counter()
    assert launch.launch(args) == code
    # rank 0 slept 120 s: it was terminated and reaped, well within the
    # shared 10 s deadline
    assert time.perf_counter() - t0 < 30
    pid0 = int((tmp_path / "pid_0").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid0, 0)
    assert utils.exit_code(-signal.SIGTERM) == 128 + signal.SIGTERM


def test_elastic_waits_for_item_6d(tmp_path):
    args = launch._parse_args(["--elastic", "x.py"])
    with pytest.raises(NotImplementedError, match="6d"):
        launch.launch(args)


def test_cluster_and_pod_match_the_jax_model():
    ips = ["10.0.0.1", "10.0.0.2", "10.0.0.3"]
    for node in ips:
        got = utils.get_cluster(ips, node, [6170, 6171], [0, 1])
        want = jutils.get_cluster(ips, node, [6170, 6171], [0, 1])
        assert str(got[0]) == str(want[0]) and str(got[1]) == str(want[1])
        assert got[0].trainers_endpoints() == want[0].trainers_endpoints()
        assert got[0].trainers_nranks() == want[0].trainers_nranks() == 6
        assert got[0].pods_nranks() == 3
        assert got[1].get_visible_gpus() == want[1].get_visible_gpus()
        assert got[0].get_pod_by_id(1).addr == "10.0.0.2"
    with pytest.raises(ValueError):
        utils.get_cluster(ips, ips[0], [6170], [0, 1])

    class Args:
        ips = "10.0.0.1,10.0.0.2"
        node_rank = 1
        started_port = 7000

    got = launch.get_cluster_from_args(Args, [0, 1])
    want = jlaunch.get_cluster_from_args(Args, [0, 1])
    assert str(got[0]) == str(want[0]) and str(got[1]) == str(want[1])
    assert launch.get_gpus("0,1") == jlaunch.get_gpus("0,1") == [0, 1]


def test_cloud_cluster_matches(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS", "10.1.0.1,10.1.0.2")
    monkeypatch.setenv("POD_IP", "10.1.0.2")
    monkeypatch.setenv("PADDLE_PORT", "6200")
    got = cloud_utils.get_cloud_cluster(selected_gpus=[0, 1])
    want = jcloud.get_cloud_cluster(selected_gpus=[0, 1])
    assert str(got[0]) == str(want[0]) and str(got[1]) == str(want[1])
    monkeypatch.delenv("POD_IP")
    with pytest.raises(ValueError):
        cloud_utils.get_cloud_cluster()
    with pytest.raises(ValueError):
        jcloud.get_cloud_cluster()
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    assert cloud_utils.get_trainers_num() == jcloud.get_trainers_num() == 4


def test_start_and_watch_local_trainers(tmp_path):
    script = _script(tmp_path, ENV_SCRIPT)
    cluster, pod = utils.get_cluster(["127.0.0.1"], "127.0.0.1",
                                     [7200, 7201], [0, 0])
    procs = utils.start_local_trainers(cluster, pod, script,
                                       [str(tmp_path)])
    deadline = time.time() + 60
    while utils.watch_local_trainers(procs, 2):
        assert time.time() < deadline
        time.sleep(0.05)
    got = json.loads((tmp_path / "rank_1.json").read_text())
    assert got["PADDLE_TRAINER_ENDPOINTS"] == "127.0.0.1:7200,127.0.0.1:7201"
    assert got["FLAGS_selected_gpus"] == "0"
    fail = _script(tmp_path, FAIL_SCRIPT)
    procs = utils.start_local_trainers(cluster, pod, fail,
                                       [str(tmp_path), "3"])
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code 3"):
        while utils.watch_local_trainers(procs, 2):
            assert time.time() < deadline + 30
            time.sleep(0.05)
    assert all(p.proc.poll() is not None for p in procs)


@pytest.mark.parametrize("axes", [None, {"data": -1}, {"data": 1},
                                  {"data": 2}, {"data": 1, "model": -1}])
def test_init_mesh_checks_as_the_jax_one(axes):
    try:
        jenv.init_mesh(axes, devices=jax.devices()[:1])
        want = None
    except ValueError:
        want = ValueError
    finally:
        jenv.set_mesh(None)
    try:
        if want is None:
            m = env.init_mesh(axes)
            assert m.size == 1 and env.mesh_axis_size("data") == 1
        else:
            with pytest.raises(want):
                env.init_mesh(axes)
    finally:
        env.set_mesh(None)
    with pytest.raises(NotImplementedError, match="6b"):
        env.init_mesh({"data": 1, "model": 2}, devices=[0, 1])


def test_a_world_of_one_and_the_backend_rule(monkeypatch):
    place = _device.CURRENT[0]
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                env.init_parallel_env(device="cuda")
        pe = env.init_parallel_env(device="cpu")
        assert (pe.world_size, pe.rank, pe.nranks, pe.local_rank,
                pe.device_id, pe.backend) == (1, 0, 1, 0, 0, None)
        assert env.get_group() is None
        assert env.init_parallel_env().world_size == 1
        assert _device.CURRENT[0] == torch.device("cpu")
    finally:
        env._shutdown()
        _device.CURRENT[0] = place
    assert env.backend_for(torch.device("cpu"), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert env.backend_for(torch.device("cuda", 0), 2) == "gloo"
    assert env.backend_for(torch.device("cuda", 0), 1) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert env.backend_for(torch.device("cuda", 0), 4) == "nccl"
    eps = ["h1:1", "h1:2", "h2:1", "h2:2"]
    assert env._local(3, 4, eps, {}) == (1, 2)
    assert env._local(0, 4, [], {}) == (0, 4)
    assert env._local(2, 4, eps, {"LOCAL_RANK": "0",
                                  "LOCAL_WORLD_SIZE": "1"}) == (0, 1)
    assert env._endpoints_env({"PADDLE_TRAINER_ID": "1",
                               "PADDLE_TRAINERS_NUM": "2",
                               "PADDLE_TRAINER_ENDPOINTS": "a:1,a:2"}) == \
        (1, 2, ["a:1", "a:2"])
    assert sys.modules["paddle_tpu_torch.dist"].spawn is None
