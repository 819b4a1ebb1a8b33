"""The port leaves torch's global state as it found it.

The JAX package's own torch tests (``tests/test_torch_parity.py``) use
torch's conv, pooling and batch norm on the CPU as their oracle, and
the test runner shares worker processes between test files: a port
module or test that changed torch's global state (deterministic
algorithms, the cuDNN flags, the default dtype, the thread count, the
default generator) could make one of them fail. In a fresh process,
this test imports every module of the port (``torch.Tensor`` must gain
no attribute: the port's ``Tensor`` is a subclass) and runs a tiny ResNet
``TrainStep`` (the state must be as it was), then runs
``tests/test_torch_resnet.py`` and, in the same process after it,
``tests/test_torch_parity.py`` (``-p no:randomly``): the state must be
as it was when the ResNet tests end, and every test must pass. About
2 minutes on the CPU.
"""
import os
import subprocess
import sys

from torch_test_threads import torch_threads  # noqa: F401,E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = r"""
import importlib, pkgutil, sys
import numpy as np, pytest, torch

def state():
    c = torch.backends.cudnn
    return dict(
        deterministic=torch.are_deterministic_algorithms_enabled(),
        warn_only=torch.is_deterministic_algorithms_warn_only_enabled(),
        cudnn=(c.enabled, c.benchmark, c.deterministic, c.allow_tf32),
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        precision=torch.get_float32_matmul_precision(),
        dtype=torch.get_default_dtype(), threads=torch.get_num_threads(),
        grad=torch.is_grad_enabled(),
        rng=torch.random.get_rng_state().clone())

def same(a, b):
    bad = [k for k in a if k != "rng" and a[k] != b[k]]
    return bad + ([] if torch.equal(a["rng"], b["rng"]) else ["rng"])

before = state()
tensor_attrs = dict(vars(torch.Tensor)), dict(vars(torch._C.TensorBase))
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
# the port's Tensor is a subclass: torch's class gains no attribute
for old, cls in zip(tensor_attrs, (torch.Tensor, torch._C.TensorBase)):
    now = dict(vars(cls))
    assert set(now) == set(old), sorted(set(now) ^ set(old))
    assert all(now[k] is old[k] for k in old), [
        k for k in old if now[k] is not old[k]]
from paddle_tpu_torch import optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.vision import resnet
from paddle_tpu_torch.nn import functional as F
g = torch.Generator().manual_seed(0)
m = resnet.ResNet(resnet.BottleneckBlock, [1, 1, 1, 1], width=8,
                  num_classes=10, device="cpu", generator=g)
opt = optim.Momentum(0.1, 0.9, parameters=m.named_parameters(),
                     multi_precision=True)
step = TrainStep(m, opt, lambda m, x, y: F.cross_entropy(m(x), y))
rng = np.random.RandomState(0)
x = rng.randn(4, 3, 32, 32).astype("float32")
y = rng.randint(0, 10, (4,)).astype("int32")
assert np.isfinite(float(step(x, y)))
bad = same(before, state())
assert not bad, f"the port changed torch's global state: {bad}"


class AfterResnet:
    # reads torch's global state once the ResNet tests are done, as the
    # first of the JAX package's tests starts
    bad = None

    def pytest_runtest_setup(self, item):
        if self.bad is None and item.path.name == "test_torch_parity.py":
            self.bad = same(before, state())


guard = AfterResnet()
rc = pytest.main(["-q", "-p", "no:randomly", "-p", "no:cacheprovider",
                  "-p", "no:xdist", "tests/test_torch_resnet.py",
                  "tests/test_torch_parity.py"], plugins=[guard])
assert rc == 0, f"pytest exited {rc}"
assert guard.bad == [], f"the ResNet tests changed the state: {guard.bad}"
print("GUARD OK")
"""


def test_port_leaves_torch_global_state_alone():
    # two intra-op threads: the process runs beside the test runner's
    # other workers, and a setting of 1 or of the core count still shows
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    tail = (proc.stdout + proc.stderr)[-4000:]
    assert proc.returncode == 0 and "GUARD OK" in proc.stdout, tail
    assert " passed" in proc.stdout and " failed" not in proc.stdout, tail
