"""paddle_tpu_torch's ``framework.io`` (``save``/``load`` and the
crash-safe checkpoints) and the optimizers' state dicts, against the
JAX package's.

The reference's own checkpoint tests, ported: the integrity class of
``tests/test_resilience.py`` (manifest, fallback from a truncated or
bit-flipped newest checkpoint, a crashed save's orphan, garbage names,
all corrupt, an explicit step corrupt, a malformed manifest, the deep
per-array pass, rotation), the async tests of ``tests/test_elastic.py``
and the save/load tests of ``tests/test_jit_io.py``, on the port's
``Linear`` (CPU).

Across the packages, a tiny GPT (vocab 256, hidden 64, 2 layers, 2
heads, 32 positions, dropout 0), float32 and bfloat16 with
``multi_precision`` AdamW at 3e-3 and global-norm clip 1.0, batches of
4 x 32 ids from ``RandomState(0)``: a JAX checkpoint after 3 steps
resumes in the port (optimizer state renamed by
``convert.optimizer_state_dict_from_jax``), a port checkpoint in the JAX
package, and the two manifests' per-array crc32s agree. Tolerances, the
resumed 3 steps against the other package's own 3: losses as
``tests/test_torch_gpt.py``'s (float32 5e-5 atol and rtol, seen 4.8e-7;
bfloat16 3e-2 atol, seen 1.3e-4); parameters float32 1e-4 atol (seen
5.4e-6, a thirtieth of one AdamW step at lr 3e-3), bfloat16 two runs'
opposite AdamW steps over the 3 steps (2 x 3 x lr: the frameworks round
bfloat16 at different places, and at steps 4-6 an element's bias-
corrected step ``m / sqrt(v)`` is at most about 1, so a flipped rounding
can move the two runs' updates apart by up to 2 lr a step) plus one
bfloat16 step of the tensor's largest |value| (seen 9.5e-3 on a qkv
bias, 7.8e-3 on a LayerNorm weight of 1.0). What is loaded is held
bitwise.

bfloat16 is written and read without ``ml_dtypes``: a subprocess with
``sys.modules["ml_dtypes"] = None`` saves and loads a bfloat16 port
checkpoint and reads one the JAX package wrote.
"""
import binascii
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optim as joptim
from paddle_tpu.models.nlp import gpt as jgpt
from paddle_tpu_torch import convert, optim
from paddle_tpu_torch.framework import (CheckpointError, TrainStep, load,
                                        load_checkpoint, save,
                                        save_checkpoint, set_state_dict,
                                        verify_checkpoint, wait_checkpoints)
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.models.nlp import gpt
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optim import lr as tlr
from paddle_tpu_torch.resilience import (SimulatedCrashError, inject,
                                         newest_intact_step)

from torch_test_threads import torch_threads  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=256, hidden=64, layers=2, heads=2, max_seq=32,
           dropout=0.0)
LR = 3e-3
LOSS_TOL = {"float32": dict(atol=5e-5, rtol=5e-5),
            "bfloat16": dict(atol=3e-2, rtol=0)}
F32_PARAM_TOL = 1e-4


def _linear(seed=0, i=4, o=2):
    return Linear(i, o, device="cpu",
                  generator=torch.Generator().manual_seed(seed))


def _age_tmp(path, secs=3600):
    """Backdate a tmp artifact past the orphan-cleanup grace period."""
    t = time.time() - secs
    for f in [path] + [os.path.join(path, f) for f in os.listdir(path)]:
        os.utime(f, (t, t))


def _bump(m):
    with torch.no_grad():
        m.weight += 1.0


def _ckpt_pair(tmp_path):
    """Two checkpoints; returns (dir, weights at step 1, weights at 2)."""
    m = _linear()
    opt = optim.SGD(learning_rate=0.1, parameters=m.named_parameters())
    save_checkpoint(str(tmp_path), 1, model=m, optimizer=opt)
    w1 = m.weight.detach().clone()
    _bump(m)
    save_checkpoint(str(tmp_path), 2, model=m, optimizer=opt)
    return str(tmp_path), w1, m.weight.detach().clone()


# -- checkpoint integrity (tests/test_resilience.py:374-530) -----------------


class TestCheckpointIntegrity:
    def test_manifest_written_and_verifies(self, tmp_path):
        d, _, _ = _ckpt_pair(tmp_path)
        path = os.path.join(d, "ckpt_2")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["format"] == 1 and manifest["step"] == 2
        assert sorted(manifest["files"]) == ["meta.pkl", "model.pdparams",
                                             "opt.pdopt"]
        assert manifest["arrays"]["model.pdparams"]["weight"]["shape"] == \
            [4, 2]
        ok, problems = verify_checkpoint(path)
        assert ok and not problems

    @pytest.mark.parametrize("point,cfg", [
        ("ckpt_truncate", {}),
        ("ckpt_bitflip", {"seed": 5}),
    ])
    def test_corrupt_newest_falls_back(self, tmp_path, point, cfg):
        m = _linear()
        opt = optim.SGD(learning_rate=0.1, parameters=m.named_parameters())
        save_checkpoint(str(tmp_path), 1, model=m, optimizer=opt)
        w1 = m.weight.detach().clone()
        _bump(m)
        with inject.chaos(point, **cfg):
            save_checkpoint(str(tmp_path), 2, model=m, optimizer=opt)
        ok, problems = verify_checkpoint(os.path.join(str(tmp_path),
                                                      "ckpt_2"))
        assert not ok and problems
        m2 = _linear(1)
        with pytest.warns(RuntimeWarning, match="falling back"):
            step = load_checkpoint(str(tmp_path), model=m2)
        assert step == 1
        assert torch.equal(m2.weight, w1)

    def test_crashed_save_leaves_orphan_then_cleaned(self, tmp_path):
        m = _linear()
        save_checkpoint(str(tmp_path), 1, model=m)
        w1 = m.weight.detach().clone()
        with inject.chaos("ckpt_crash"):
            with pytest.raises(SimulatedCrashError):
                save_checkpoint(str(tmp_path), 2, model=m)
        orphans = [f for f in os.listdir(str(tmp_path))
                   if f.startswith(".tmp_ckpt_")]
        assert orphans
        # a FRESH tmp dir may belong to a live concurrent saver: the
        # loader must leave it alone...
        m2 = _linear(1)
        assert load_checkpoint(str(tmp_path), model=m2) == 1
        assert torch.equal(m2.weight, w1)
        assert any(f.startswith(".tmp_ckpt_")
                   for f in os.listdir(str(tmp_path)))
        # ...but once it has gone stale it is a crash artifact and goes
        _age_tmp(os.path.join(str(tmp_path), orphans[0]))
        with pytest.warns(RuntimeWarning, match="orphaned"):
            assert load_checkpoint(str(tmp_path), model=m2) == 1
        assert not any(f.startswith(".tmp_ckpt_")
                       for f in os.listdir(str(tmp_path)))

    def test_garbage_dirs_ignored(self, tmp_path):
        d, w1, w2 = _ckpt_pair(tmp_path)
        os.makedirs(os.path.join(d, "ckpt_latest"))  # non-numeric garbage
        os.makedirs(os.path.join(d, "ckpt_1x2"))
        m2 = _linear(1)
        with pytest.warns(RuntimeWarning, match="non-checkpoint"):
            step = load_checkpoint(d, model=m2)
        assert step == 2
        assert torch.equal(m2.weight, w2)

    def test_all_corrupt_raises_not_silent_restart(self, tmp_path):
        d, _, _ = _ckpt_pair(tmp_path)
        for name in ("ckpt_1", "ckpt_2"):
            with open(os.path.join(d, name, "model.pdparams"), "r+b") as f:
                f.truncate(10)
        with pytest.warns(RuntimeWarning):
            with pytest.raises(CheckpointError, match="every checkpoint"):
                load_checkpoint(d, model=_linear(1))

    def test_explicit_step_corrupt_raises(self, tmp_path):
        d, _, _ = _ckpt_pair(tmp_path)
        with open(os.path.join(d, "ckpt_2", "model.pdparams"), "r+b") as f:
            f.truncate(10)
        with pytest.raises(CheckpointError):
            load_checkpoint(d, model=_linear(1), step=2)
        with pytest.raises(CheckpointError, match="no checkpoint for step"):
            load_checkpoint(d, step=99)

    def test_malformed_but_valid_json_manifest_falls_back(self, tmp_path):
        d, w1, _ = _ckpt_pair(tmp_path)
        with open(os.path.join(d, "ckpt_2", "manifest.json"), "w") as f:
            json.dump({"files": {"model.pdparams": {"siz": 1}}}, f)
        m2 = _linear(1)
        with pytest.warns(RuntimeWarning, match="falling back"):
            assert load_checkpoint(d, model=m2) == 1
        assert torch.equal(m2.weight, w1)

    def test_deep_verify_catches_array_level_edit(self, tmp_path):
        """A file whose file-level digest was regenerated around an edited
        array is caught by the per-array pass, which names the array."""
        d, _, _ = _ckpt_pair(tmp_path)
        p = os.path.join(d, "ckpt_2", "model.pdparams")
        state = load(p)
        state["weight"] = state["weight"] + 1.0  # tampered array
        save(state, p)
        with open(p, "rb") as f:
            blob = f.read()
        mpath = os.path.join(d, "ckpt_2", "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        manifest["files"]["model.pdparams"] = {
            "size": len(blob), "crc32": binascii.crc32(blob) & 0xFFFFFFFF}
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        ok, problems = verify_checkpoint(os.path.join(d, "ckpt_2"))
        assert not ok and "per-array checksum mismatch" in problems[0]
        assert "'weight'" in problems[0]

    def test_newest_intact_step_names_what_load_resumes(self, tmp_path):
        """On an array edited under a regenerated file crc, the step
        ``newest_intact_step`` names is the one ``load_checkpoint``
        resumes from: both apply the file-level checks only."""
        d, _, _ = _ckpt_pair(tmp_path)
        p = os.path.join(d, "ckpt_2", "model.pdparams")
        state = load(p)
        state["weight"] = state["weight"] + 1.0
        save(state, p)
        with open(p, "rb") as f:
            blob = f.read()
        mpath = os.path.join(d, "ckpt_2", "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        manifest["files"]["model.pdparams"] = {
            "size": len(blob), "crc32": binascii.crc32(blob) & 0xFFFFFFFF}
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        assert not verify_checkpoint(os.path.join(d, "ckpt_2"))[0]
        assert newest_intact_step(d) == load_checkpoint(d, _linear()) == 2

    def test_rotation_survives_garbage(self, tmp_path):
        d = str(tmp_path)
        os.makedirs(os.path.join(d, "ckpt_latest"))
        m = _linear(0, 2, 2)
        for s in range(1, 6):
            save_checkpoint(d, s, model=m, keep_last=2)
        kept = sorted(f for f in os.listdir(d) if f.startswith("ckpt_")
                      and f[5:].isdigit())
        assert kept == ["ckpt_4", "ckpt_5"]

    def test_newest_intact_step(self, tmp_path):
        d, _, _ = _ckpt_pair(tmp_path)
        assert newest_intact_step(d) == 2
        with open(os.path.join(d, "ckpt_2", "opt.pdopt"), "r+b") as f:
            f.truncate(5)
        assert newest_intact_step(d) == 1
        assert newest_intact_step(str(tmp_path / "none")) is None


# -- async checkpointing (tests/test_elastic.py:178-300) ---------------------


def test_async_save_matches_sync_bitwise(tmp_path):
    m = _linear()
    d_sync, d_async = str(tmp_path / "s"), str(tmp_path / "a")
    save_checkpoint(d_sync, 3, model=m)
    h = save_checkpoint(d_async, 3, model=m, async_=True)
    assert h.result(timeout=30.0) == os.path.join(d_async, "ckpt_3")
    assert h.done()
    ms, ma = _linear(1), _linear(2)
    assert load_checkpoint(d_sync, model=ms) == 3
    assert load_checkpoint(d_async, model=ma) == 3
    assert torch.equal(ms.weight, ma.weight) and torch.equal(ms.weight,
                                                             m.weight)
    for name in ("model.pdparams", "meta.pkl"):
        with open(os.path.join(d_sync, "ckpt_3", name), "rb") as f, \
                open(os.path.join(d_async, "ckpt_3", name), "rb") as g:
            assert f.read() == g.read()


def test_async_save_never_blocks_the_step_loop(tmp_path):
    """With the write stalled 0.6 s (``ckpt_slow``), ``save_checkpoint(
    async_=True)`` returns in a fraction of that, and the checkpoint is
    published only once the writer completed."""
    m = _linear()
    d = str(tmp_path / "ck")
    with inject.chaos("ckpt_slow", seconds=0.6):
        t0 = time.perf_counter()
        h = save_checkpoint(d, 1, model=m, async_=True)
        step_path_s = time.perf_counter() - t0
        assert not os.path.exists(os.path.join(d, "ckpt_1"))
        # a load issued NOW must neither sweep the live writer's tmp dir
        # nor see a half-written checkpoint
        assert load_checkpoint(d, model=_linear(1)) is None
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            if os.path.isdir(d) and any(
                    f.startswith(".tmp_ckpt_1") for f in os.listdir(d)):
                break
            time.sleep(0.005)
        assert any(f.startswith(".tmp_ckpt_1") for f in os.listdir(d))
        assert not os.path.exists(os.path.join(d, "ckpt_1"))
        h.result(timeout=30.0)
    assert step_path_s < 0.3, \
        f"async save held the step path {step_path_s:.3f}s of a 0.6s write"
    assert os.path.isdir(os.path.join(d, "ckpt_1"))
    assert load_checkpoint(d, model=_linear(1)) == 1


def test_async_snapshot_owns_its_bytes(tmp_path):
    """The step loop overwrites the live storage while the writer is
    stalled: the checkpoint holds the values of the save's call."""
    m = _linear()
    want = m.weight.detach().clone()
    d = str(tmp_path / "ck")
    with inject.chaos("ckpt_slow", seconds=0.3):
        h = save_checkpoint(d, 1, model=m, async_=True)
        _bump(m)
        h.result(timeout=30.0)
    m2 = _linear(1)
    assert load_checkpoint(d, model=m2) == 1
    assert torch.equal(m2.weight, want)


def test_save_barriers_on_previous_inflight_save(tmp_path):
    m = _linear()
    d = str(tmp_path / "ck")
    with inject.chaos("ckpt_slow", seconds=0.4):
        h1 = save_checkpoint(d, 1, model=m, async_=True)
        save_checkpoint(d, 2, model=m)
    assert h1.done() and h1.error is None
    names = sorted(f for f in os.listdir(d) if f.startswith("ckpt_"))
    assert names == ["ckpt_1", "ckpt_2"]


def test_async_writer_failure_surfaces_once_then_clears(tmp_path):
    m = _linear()
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, model=m)  # the intact fallback target
    with inject.chaos("ckpt_crash"):
        h = save_checkpoint(d, 2, model=m, async_=True)
        with pytest.raises(SimulatedCrashError):
            wait_checkpoints(timeout=30.0)
    assert h.error is not None
    assert wait_checkpoints() is None  # settled: raised once, cleared
    m2 = _linear(1)
    assert load_checkpoint(d, model=m2) == 1
    assert torch.equal(m.weight, m2.weight)


def test_wait_checkpoints_idle_returns_none():
    assert wait_checkpoints() is None


def test_writer_killed_mid_save_leaves_only_tmp_orphan(tmp_path):
    """A process that dies WHILE the async writer is stalled leaves only
    a ``.tmp_ckpt_*`` orphan; the next load sweeps it once stale and
    resumes from the newest intact checkpoint."""
    d = str(tmp_path / "ck")
    script = textwrap.dedent(f"""
        import os, sys, time
        sys.path.insert(0, {REPO!r})
        import torch
        from paddle_tpu_torch.framework import save_checkpoint
        from paddle_tpu_torch.nn import Linear
        from paddle_tpu_torch.resilience import inject

        m = Linear(4, 2, device="cpu",
                   generator=torch.Generator().manual_seed(0))
        save_checkpoint({d!r}, 1, model=m)
        inject.install_from_env("ckpt_slow:seconds=120")
        h = save_checkpoint({d!r}, 2, model=m, async_=True)
        tmp = os.path.join({d!r}, ".tmp_ckpt_2")
        deadline = time.monotonic() + 30
        while not os.path.exists(os.path.join(tmp, "manifest.json")):
            if time.monotonic() > deadline:
                sys.exit(99)
            time.sleep(0.01)
        os._exit(17)  # machine loss: the writer dies inside the stall
        """)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PADDLE_TPU_CHAOS=""))
    assert r.returncode == 17, (r.returncode, r.stdout, r.stderr)
    names = sorted(os.listdir(d))
    assert "ckpt_1" in names and "ckpt_2" not in names, names
    assert ".tmp_ckpt_2" in names, names
    _age_tmp(os.path.join(d, ".tmp_ckpt_2"))
    m2 = _linear(1)
    with pytest.warns(RuntimeWarning, match="orphaned"):
        assert load_checkpoint(d, model=m2) == 1
    assert not any(f.startswith(".tmp_ckpt_") for f in os.listdir(d))
    assert torch.equal(m2.weight, _linear(0).weight)


# -- save/load (tests/test_jit_io.py:85-143) ---------------------------------


def _problem():
    rng = np.random.RandomState(0)
    X = rng.randn(64, 8).astype("float32")
    Y = (X @ rng.randn(8, 1)).astype("float32")
    return torch.from_numpy(X), torch.from_numpy(Y)


def test_save_load_state_dict(tmp_path):
    m = _linear(0, 4, 3)
    p = str(tmp_path / "model.pdparams")
    save(m.state_dict(), p)
    m2 = _linear(1, 4, 3)
    assert set_state_dict(m2, load(p)) == ([], [])
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 4).astype(
        "float32"))
    assert torch.equal(m(x), m2(x))


def test_checkpoint_resume(tmp_path):
    X, Y = _problem()
    d = str(tmp_path / "ckpts")
    m = _linear(0, 8, 1)
    sched = tlr.StepDecay(0.1, step_size=5)
    opt = optim.Adam(sched, parameters=m.named_parameters())
    for i in range(3):
        loss = ((m(X) - Y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        save_checkpoint(d, i, m, opt, sched, keep_last=2)
    assert sorted(os.listdir(d)) == ["ckpt_1", "ckpt_2"]  # rotation
    m2 = _linear(1, 8, 1)
    sched2 = tlr.StepDecay(0.1, step_size=5)
    opt2 = optim.Adam(sched2, parameters=m2.named_parameters())
    assert load_checkpoint(d, m2, opt2, sched2) == 2
    assert torch.equal(m2.weight, m.weight)
    assert sched2.last_epoch == sched.last_epoch
    assert opt2._global_step == 3
    for n, s in opt._accumulators.items():
        for k, v in s.items():
            assert torch.equal(opt2._accumulators[n][k], v), (n, k)


def test_load_checkpoint_empty_dir(tmp_path):
    assert load_checkpoint(str(tmp_path / "none")) is None


# -- the state dicts ---------------------------------------------------------


def _adamw(m, **kw):
    return optim.AdamW(parameters=m.named_parameters(), learning_rate=LR,
                       grad_clip=optim.ClipGradByGlobalNorm(1.0), **kw)


def test_set_state_dict_writes_into_the_existing_storage():
    m = _linear()
    opt = _adamw(m)
    x = torch.ones(3, 4)
    m(x).sum().backward()
    opt.step()
    ptrs = {(n, k): v.data_ptr() for n, s in opt._accumulators.items()
            for k, v in s.items()}
    state = {k: (v.clone() + 1 if isinstance(v, torch.Tensor) else v)
             for k, v in opt.state_dict().items()}
    state["@global_step"] = 7
    opt.set_state_dict(state)
    assert opt._global_step == 7
    for (n, k), ptr in ptrs.items():
        assert opt._accumulators[n][k].data_ptr() == ptr
        assert torch.equal(opt._accumulators[n][k], state[f"{n}.{k}"])
    wptr = m.weight.data_ptr()
    set_state_dict(m, {"weight": np.zeros((4, 2), np.float32)})
    assert m.weight.data_ptr() == wptr and not m.weight.any()


def test_set_state_dict_makes_missing_state_first():
    """A fresh optimizer has no state until its first step: loading
    makes it (a master from the current parameter), then writes it."""
    m = _linear().bfloat16()
    src = _adamw(m, multi_precision=True)
    m(torch.ones(3, 4, dtype=torch.bfloat16)).sum().backward()
    src.step()
    fresh = _adamw(m, multi_precision=True)
    assert not fresh._accumulators
    fresh.set_state_dict(src.state_dict())
    assert sorted(fresh._accumulators["weight"]) == [
        "beta1_pow", "beta2_pow", "master", "moment1", "moment2"]
    for n, s in src._accumulators.items():
        for k, v in s.items():
            assert torch.equal(fresh._accumulators[n][k], v)


@pytest.mark.parametrize("key,value,match", [
    ("nope.moment1", np.zeros((4, 2), np.float32), "no parameter"),
    ("weight.velocity", np.zeros((4, 2), np.float32), "keeps"),
    ("weight.moment1", np.zeros((2, 4), np.float32), "shape"),
])
def test_set_state_dict_rejects_what_does_not_fit(key, value, match):
    opt = _adamw(_linear())
    with pytest.raises(ValueError, match=match):
        opt.set_state_dict({key: value})


def test_model_set_state_dict_contract():
    m = _linear()
    missing, unexpected = set_state_dict(
        m, {"weight": np.ones((4, 2), np.float32), "extra": np.ones(3)})
    assert missing == ["bias"] and unexpected == ["extra"]
    assert torch.equal(m.weight, torch.ones(4, 2))
    with pytest.raises(ValueError, match="shape mismatch for weight"):
        set_state_dict(m, {"weight": np.ones((2, 4), np.float32)})


def test_bfloat16_pickle_is_numpys_ml_dtypes_pickle(tmp_path):
    """The port writes a bfloat16 tensor as the bytes numpy pickles an
    ``ml_dtypes.bfloat16`` array to, and reads them back bitwise."""
    import ml_dtypes

    t = (torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7).bfloat16()
    ref = {"w": t.float().numpy().astype(ml_dtypes.bfloat16),
           "b": np.arange(3, dtype=np.float32), "n": 4,
           "v": (t[0] * 3).float().numpy().astype(ml_dtypes.bfloat16),
           "s": np.zeros((), ml_dtypes.bfloat16)}
    p = str(tmp_path / "x.pdparams")
    save({"w": t, "b": torch.arange(3, dtype=torch.float32), "n": 4,
          "v": t[0] * 3, "s": torch.zeros((), dtype=torch.bfloat16)}, p)
    with open(p, "rb") as f:
        assert f.read() == pickle.dumps(ref, protocol=4)
    back = load(p)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t)
    assert back["b"].dtype == np.float32 and back["n"] == 4
    with open(p, "rb") as f:
        assert pickle.load(f)["w"].dtype == ml_dtypes.bfloat16


# -- across the packages -----------------------------------------------------


def _batches(n=6):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        ids = rng.randint(0, CFG["vocab_size"], (4, 32)).astype("int32")
        out.append((ids, np.roll(ids, -1, axis=1).astype("int32")))
    return out


def _jax_step(dtype):
    pt.seed(0)
    jm = jgpt.GPT(jgpt.GPTConfig(**CFG))
    if dtype == "bfloat16":
        jm.bfloat16()
    jopt = joptim.AdamW(parameters=jm.parameters(), learning_rate=LR,
                        multi_precision=dtype == "bfloat16",
                        grad_clip=joptim.ClipGradByGlobalNorm(1.0))
    return jm, jopt, pt.TrainStep(jm, jopt, jgpt.gpt_loss)


def _port_step(dtype, seed):
    m = gpt.GPT(gpt.GPTConfig(**CFG, dtype=dtype), device="cpu",
                generator=torch.Generator().manual_seed(seed))
    opt = _adamw(m, multi_precision=dtype == "bfloat16")
    return m, opt, TrainStep(m, opt, gpt.gpt_loss)


def _np(t):
    return t.detach().float().numpy()


def _jnp(p):
    return np.asarray(p._data).astype(np.float32)


def _param_tol(dtype, scale):
    return (F32_PARAM_TOL if dtype == "float32"
            else 2 * 3 * LR + 2 ** -7 * scale)


def _held(dtype, got, want):
    """``got`` (port parameters) against ``want`` (JAX's, by name)."""
    assert sorted(got) == sorted(want)
    for n, a in got.items():
        b = want[n]
        np.testing.assert_allclose(
            a, b, rtol=0, atol=_param_tol(dtype, np.abs(b).max()),
            err_msg=n)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_run(request, tmp_path_factory):
    """3 JAX AdamW steps, a JAX checkpoint, then 3 more JAX steps:
    ``(dtype, dir, losses 4-6, parameters after 6, JAX names in order)``."""
    dtype = request.param
    d = str(tmp_path_factory.mktemp(f"jax_{dtype}"))
    jm, jopt, jstep = _jax_step(dtype)
    batches = _batches()
    for b in batches[:3]:
        jstep(*b)
    pt.framework.save_checkpoint(d, 3, jm, jopt)
    losses = [float(np.asarray(jstep(*b)._data)) for b in batches[3:]]
    params = {n: _jnp(p) for n, p in jm.named_parameters()}
    return dtype, d, losses, params, [p.name for p in jopt._param_groups]


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    dtype, d, want_losses, want_params, jnames = jax_run
    m, opt, step = _port_step(dtype, seed=5)
    assert load_checkpoint(d, model=m) == 3
    ck = os.path.join(d, "ckpt_3")
    jstate = load(os.path.join(ck, "opt.pdopt"))
    # the default order (the state's) and the JAX optimizer's agree
    renamed = convert.optimizer_state_dict_from_jax(jstate, opt)
    assert renamed == convert.optimizer_state_dict_from_jax(
        jstate, opt, names=dict(zip(jnames, [n for n, _ in
                                             opt._named_params])))
    opt.set_state_dict(renamed)
    assert opt._global_step == 3
    # what was loaded is the JAX checkpoint's, bitwise
    jmodel = load(os.path.join(ck, "model.pdparams"))
    for n, t in m.state_dict().items():
        assert torch.equal(t, torch.as_tensor(jmodel[n])), n
    for k, v in renamed.items():
        if not k.startswith("@"):
            name, slot = k.rsplit(".", 1)
            assert torch.equal(opt._accumulators[name][slot],
                               torch.as_tensor(v)), k
    batches = _batches()
    got = [float(step(*b)) for b in batches[3:]]
    np.testing.assert_allclose(got, want_losses, **LOSS_TOL[dtype])
    _held(dtype, {n: _np(p) for n, p in m.named_parameters()}, want_params)


def test_port_checkpoint_loads_into_the_jax_package(jax_run, tmp_path):
    dtype, _, _, _, _ = jax_run
    batches = _batches()
    m, opt, step = _port_step(dtype, seed=0)
    jm0, jopt0, _ = _jax_step(dtype)     # the port starts from JAX's init
    set_state_dict(m, {n: _jnp(p) if dtype == "float32" else
                       torch.from_numpy(_jnp(p)).bfloat16()
                       for n, p in jm0.named_parameters()})
    for b in batches[:3]:
        step(*b)
    d = str(tmp_path / "port")
    save_checkpoint(d, 3, m, opt)
    jm, jopt, jstep = _jax_step(dtype)
    assert pt.framework.load_checkpoint(d, jm) == 3
    for n, p in jm.named_parameters():
        assert str(np.asarray(p._data).dtype) == dtype
        np.testing.assert_array_equal(_jnp(p), _np(dict(
            m.named_parameters())[n]), err_msg=n)
    # the optimizer state under the JAX names, then 3 more steps on each
    tnames = [n for n, _ in opt._named_params]
    to_jax = dict(zip(tnames, [p.name for p in jopt._param_groups]))
    with open(os.path.join(d, "ckpt_3", "opt.pdopt"), "rb") as f:
        pstate = pickle.load(f)
    jopt.set_state_dict({k if k.startswith("@") else
                         f"{to_jax[k.rsplit('.', 1)[0]]}."
                         f"{k.rsplit('.', 1)[1]}": v
                         for k, v in pstate.items()})
    assert jopt._global_step == 3
    want = [float(np.asarray(jstep(*b)._data)) for b in batches[3:]]
    got = [float(step(*b)) for b in batches[3:]]
    np.testing.assert_allclose(got, want, **LOSS_TOL[dtype])
    _held(dtype, {n: _np(p) for n, p in m.named_parameters()},
          {n: _jnp(p) for n, p in jm.named_parameters()})


def test_per_array_crc32s_equal_across_the_packages(jax_run, tmp_path):
    """The same state saved by both packages: the manifests' per-array
    records (crc32, shape, dtype) are equal, model and optimizer (under
    the port's names), and so are the model files' bytes."""
    dtype, d, _, _, _ = jax_run
    m, opt, _ = _port_step(dtype, seed=5)
    load_checkpoint(d, model=m)
    jstate = load(os.path.join(d, "ckpt_3", "opt.pdopt"))
    opt.set_state_dict(convert.optimizer_state_dict_from_jax(jstate, opt))
    save_checkpoint(str(tmp_path), 3, m, opt)
    with open(os.path.join(d, "ckpt_3", "manifest.json")) as f:
        jman = json.load(f)
    with open(tmp_path / "ckpt_3" / "manifest.json") as f:
        tman = json.load(f)
    assert tman["arrays"]["model.pdparams"] == \
        jman["arrays"]["model.pdparams"]
    assert tman["files"]["model.pdparams"] == \
        jman["files"]["model.pdparams"]
    jnames = list(dict.fromkeys(k.rsplit(".", 1)[0] for k in jstate
                                if not k.startswith("@")))
    to_port = dict(zip(jnames, [n for n, _ in opt._named_params]))
    renamed = {f"{to_port[k.rsplit('.', 1)[0]]}.{k.rsplit('.', 1)[1]}": v
               for k, v in jman["arrays"]["opt.pdopt"].items()}
    assert tman["arrays"]["opt.pdopt"] == renamed


def test_optimizer_state_dict_rename_rejects_what_does_not_fit():
    m, opt, _ = _port_step("float32", seed=0)
    with pytest.raises(ValueError, match="JAX parameters"):
        convert.optimizer_state_dict_from_jax({"a.moment1": 0}, opt)
    with pytest.raises(ValueError, match="maps to no parameter"):
        convert.optimizer_state_dict_from_jax(
            {"a.moment1": 0}, opt, names={"b": "wte.weight"})


_NO_ML_DTYPES = """
import os, sys
sys.modules["ml_dtypes"] = None           # any import of it now fails
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from paddle_tpu_torch.framework import load_checkpoint, save_checkpoint
from paddle_tpu_torch.models.nlp import gpt

cfg = dict(vocab_size=256, hidden=64, layers=2, heads=2, max_seq=32,
           dropout=0.0, dtype="bfloat16")

def model(seed):
    return gpt.GPT(gpt.GPTConfig(**cfg), device="cpu",
                   generator=torch.Generator().manual_seed(seed))

# the JAX package's bfloat16 checkpoint, against its values in float32
m = model(1)
assert load_checkpoint(sys.argv[2], model=m) == 3
want = np.load(sys.argv[3])
for n, p in m.named_parameters():
    assert p.dtype == torch.bfloat16
    assert torch.equal(p.float(), torch.from_numpy(want[n])), n
# the port's own, written and read back
a, b = model(2), model(3)
save_checkpoint(sys.argv[4], 7, model=a)
assert load_checkpoint(sys.argv[4], model=b) == 7
for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
    assert torch.equal(x, y), n
assert sys.modules["ml_dtypes"] is None
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "paddle_tpu", "ml_dtypes")
             and sys.modules[k] is not None)
assert not bad, bad
print("NO-ML-DTYPES OK")
"""


def test_bfloat16_checkpoints_without_ml_dtypes(tmp_path):
    jm, jopt, jstep = _jax_step("bfloat16")
    for b in _batches(3):
        jstep(*b)
    jdir = str(tmp_path / "jax")
    pt.framework.save_checkpoint(jdir, 3, jm, jopt)
    want = str(tmp_path / "want.npz")
    np.savez(want, **{n: _jnp(p) for n, p in jm.named_parameters()})
    out = subprocess.run(
        [sys.executable, "-c", _NO_ML_DTYPES, REPO, jdir, want,
         str(tmp_path / "port")], capture_output=True, text=True,
        timeout=300,
        env=dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO-ML-DTYPES OK" in out.stdout


def test_checkpoint_of_a_bfloat16_tree_keeps_every_array(tmp_path):
    """The manifest's per-array records of a bfloat16 model name each
    array ``bfloat16`` with its shape, and a deep verify passes."""
    m = gpt.GPT(gpt.GPTConfig(**CFG, dtype="bfloat16"), device="cpu",
                generator=torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), 1, model=m)
    with open(os.path.join(path, "manifest.json")) as f:
        arrays = json.load(f)["arrays"]["model.pdparams"]
    assert sorted(arrays) == sorted(m.state_dict())
    for n, t in m.state_dict().items():
        assert arrays[n]["dtype"] == "bfloat16"
        assert arrays[n]["shape"] == list(t.shape)
        assert arrays[n] == tio._array_checksums({n: t})[n]
    assert verify_checkpoint(path) == (True, [])
