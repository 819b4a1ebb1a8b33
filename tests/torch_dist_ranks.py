"""The rank side of the ``test_torch_dist_*`` modules: one process a rank
of a gloo group on the CPU, meeting through a ``FileStore`` under the
test's directory. It imports torch and ``paddle_tpu_torch`` only (never a
test module, which imports JAX), so that a rank starts in a few seconds.

    python tests/torch_dist_ranks.py <scenario> <rank> <world> <dir>

Each scenario runs every case of its test module once and writes the
rank's results to ``<dir>/<scenario>_<world>_<rank>.npz`` (arrays) and
``.json`` (everything else); a failure writes its traceback to
``.err`` and exits 1. Inputs come from ``RandomState`` seeds the tests
share, and models from the state dicts the tests write to ``<dir>``
(``gpt_init.npz``, ``bn_init.npz``): the JAX package's weights through
``convert``.

``spawn(scenario, world, dir)`` starts the ranks (``start``) and
``collect`` waits for them and reads their results.
"""
import json
import os
import subprocess
import sys
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny GPT of tests/test_torch_gpt.py, float32, dropout 0
GPT_CFG = dict(vocab_size=512, hidden=128, layers=2, heads=2, max_seq=128,
               dropout=0.0)
GPT_LR = 3e-3
# plain SGD's rate: its update is the exchanged gradient times the rate,
# so a wrong gradient scale shows in the parameters
GPT_SGD_LR = 0.5
GPT_STEPS = 8
GPT_BATCH = 8
# the bucket caps of the bucketed runs: several buckets over the tiny GPT
BUCKET_BYTES = 1 << 18
LAST_BUCKET_BYTES = 1 << 16
# the conv-BN net of the norm scenario and its batch
BN_BATCH = (8, 3, 6, 6)
BN_CLASSES = 5
BN_STEPS = 4
BN_LR = 0.1


def gpt_batches(n=GPT_STEPS, seed=0, batch=GPT_BATCH):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, GPT_CFG["vocab_size"],
                          (batch, GPT_CFG["max_seq"])).astype("int32")
        out.append((ids, np.roll(ids, -1, axis=1).astype("int32")))
    return out


def bn_batches(n=BN_STEPS, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*BN_BATCH).astype(np.float32) * 2 + 0.5,
             rng.randint(0, BN_CLASSES, (BN_BATCH[0],)).astype("int64"))
            for _ in range(n)]


def collective_inputs(world, seed=0):
    """The global arrays of the collective cases (the JAX package's view:
    rank r holds rows [r*k, (r+1)*k))."""
    rng = np.random.RandomState(seed + world)
    n = world
    return {
        "x": rng.randn(2 * n, 3).astype(np.float32),
        "prod": (rng.uniform(0.5, 1.5, (2 * n, 3))
                 * np.where(rng.rand(2 * n, 3) < 0.3, -1, 1)
                 ).astype(np.float32),
        "ints": rng.randint(-50, 50, (2 * n, 4)).astype(np.int32),
        "rs": rng.randn(2 * n * n, 3).astype(np.float32),
        "a2a": rng.randn(n * n * 2, 3).astype(np.float32),
        "odd": rng.randn(3 * n, 2).astype(np.float32),
    }


def exchange_inputs(world, F, seed=0):
    """Per-rank local flats ``(world, F)`` for two buckets, the residuals
    and the salt of the exchange cases."""
    rng = np.random.RandomState(seed)
    flats = [rng.randn(world, F).astype(np.float32) * 3,
             rng.randn(world, F // 2).astype(np.float32)]
    resid = [rng.randn(world, f.shape[1]).astype(np.float32) * 1e-2
             for f in flats]
    return flats, resid, 2 ** 31 + 12345


def _block(a, rank, world):
    k = a.shape[0] // world
    return a[rank * k:(rank + 1) * k]


def _caught(fn):
    try:
        fn()
    except Exception as e:     # the case records what raised
        return type(e).__name__
    return None


# -- scenarios -----------------------------------------------------------------


def collectives(rank, world, d):
    import torch

    from paddle_tpu_torch import dist

    g = collective_inputs(world)
    t = {k: torch.from_numpy(_block(v, rank, world).copy())
         for k, v in g.items()}
    out, meta = {}, {}
    for op in ("sum", "max", "min"):
        out[f"all_reduce_{op}"] = dist.all_reduce(t["x"].clone(), op=op)
    out["all_reduce_prod"] = dist.all_reduce(t["prod"].clone(),
                                             op=dist.ReduceOp.PROD)
    out["all_reduce_ints"] = dist.all_reduce(t["ints"].clone())
    s = torch.tensor(float(rank + 1))
    out["all_reduce_scalar"] = dist.all_reduce(s.clone())
    out["all_gather"] = dist.all_gather(t["x"].clone())
    parts = dist.all_gather([], t["x"].clone())
    meta["all_gather_list_len"] = len(parts)
    for i, p in enumerate(parts):
        out[f"all_gather_list_{i}"] = p
    out["reduce_scatter"] = dist.reduce_scatter(t["rs"].clone())
    meta["reduce_scatter_odd"] = _caught(
        lambda: dist.reduce_scatter(t["odd"][:3].clone()))
    out["broadcast"] = dist.broadcast(t["x"].clone(), src=world - 1)
    out["all_to_all"] = dist.all_to_all(t["a2a"].clone())
    meta["all_to_all_odd"] = _caught(
        lambda: dist.all_to_all(t["odd"][:3].clone()))
    ring = [(i, (i + 1) % world) for i in range(world)]
    out["ppermute"] = dist.ppermute(t["x"].clone(), ring)
    out["reduce"] = dist.reduce(t["x"].clone(), dst=0)
    full = torch.from_numpy(g["x"].copy())
    out["scatter"] = dist.scatter(full.clone(), src=0)
    out["scatter_list"] = dist.scatter(
        torch.zeros_like(t["x"]), list(full.chunk(world)), src=0)
    dist.barrier()
    meta["world"] = dist.get_world_size()
    meta["rank"] = dist.get_rank()
    meta["backend"] = dist.ParallelEnv().backend
    meta["stats"] = {k: v for k, v in dist.collective.STATS.items()}
    return out, meta


def exchange(rank, world, d):
    import torch

    from paddle_tpu_torch.dist import gradcomm

    F = 96
    flats, resid, salt = exchange_inputs(world, F)
    entries = [("a", (F,), np.float32), ("b", (F // 2,), np.float32)]
    out = {}
    for q in (None, "int8"):
        plan = gradcomm.plan_buckets(
            entries, gradcomm.CommOptions(bucket_bytes=F * 4,
                                          last_bucket_bytes=F * 4,
                                          quantize=q), world)
        mine = [torch.from_numpy(f[rank].copy()) for f in flats]
        rs = [torch.from_numpy(r[rank].copy()) for r in resid]
        got = gradcomm.exchange_bucketed(
            plan, mine, residuals=rs if q else None,
            salt=torch.tensor(salt) if q else None)
        for i, f in enumerate(got):
            out[f"{q}_reduced_{i}"] = f
            if q:
                out[f"{q}_resid_{i}"] = rs[i]
    return out, {}


def _gpt(init, device="cpu"):
    import torch

    from paddle_tpu_torch.models.nlp import gpt

    m = gpt.GPT(gpt.GPTConfig(**GPT_CFG), device=device)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return m


def _adamw(m):
    from paddle_tpu_torch import optim

    return optim.AdamW(parameters=m.named_parameters(),
                       learning_rate=GPT_LR,
                       grad_clip=optim.ClipGradByGlobalNorm(1.0))


def _state(step):
    out = {f"param.{n}": p.detach() for n, p in step.model.named_parameters()}
    for n, s in step.optimizer._accumulators.items():
        for k, v in s.items():
            out[f"opt.{n}.{k}"] = v
    return out


def _train(init, comm=None, wrap=None, steps=GPT_STEPS, **kw):
    import torch

    from paddle_tpu_torch import dist
    from paddle_tpu_torch.models.nlp import gpt

    m = _gpt(init)
    model = wrap(m) if wrap is not None else m
    step = dist.DistributedTrainStep(model, _adamw(m), gpt.gpt_loss,
                                     comm_options=comm, **kw)
    losses = [step(*b) for b in gpt_batches()[:steps]]
    return step, torch.stack(losses) if losses else None


def train(rank, world, d):
    """Implicit, bucketed and int8 trajectories, the exchanges' counts,
    the checkpoint continuity of the int8 state and the errors."""
    import tempfile

    import torch

    from paddle_tpu_torch import dist
    from paddle_tpu_torch.dist import gradcomm
    from paddle_tpu_torch.framework import io
    from paddle_tpu_torch.models.nlp import gpt

    init = dict(np.load(os.path.join(d, "gpt_init.npz")))
    out, meta = {}, {}
    dist.init_mesh({"data": world})
    implicit, out["implicit"] = _train(init)
    meta["implicit_exchange"] = implicit.last_exchange
    bucketed, out["bucketed"] = _train(init, wrap=lambda m: dist.DataParallel(
        m, comm_buffer_size=BUCKET_BYTES / gradcomm.MB,
        last_comm_buffer_size=LAST_BUCKET_BYTES / gradcomm.MB))
    meta["bucketed_exchange"] = bucketed.last_exchange
    meta["bucketed_buckets"] = bucketed._exchange.plan.n_buckets
    meta["exchanges"] = [implicit.exchanges, bucketed.exchanges]
    for tag, s in (("implicit", implicit), ("bucketed", bucketed)):
        for k, v in _state(s).items():
            out[f"{tag}.{k}"] = v
    q = gradcomm.CommOptions(quantize="int8")
    int8, out["int8"] = _train(init, comm=q)
    meta["int8_exchange"] = int8.last_exchange
    ostate = int8.optimizer.state_dict()
    meta["int8_count"] = int(ostate[gradcomm.STEP_VAR + ".count"])
    for i in range(int8._exchange.plan.n_buckets):
        out[f"int8.resid.{i}"] = ostate[f"{gradcomm.EF_PREFIX}{i}.residual"]
    # the int8 state through state_dict and through a checkpoint: 3
    # steps, then a fresh model and optimizer from them, 2 more steps
    batches = gpt_batches()
    first, fresh = _train(init, comm=q, steps=3)
    sd = {k: v.clone() for k, v in first.model.state_dict().items()}
    osd = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
           for k, v in first.optimizer.state_dict().items()}
    m2 = _gpt(init)
    m2.load_state_dict(sd)
    o2 = _adamw(m2)
    o2.set_state_dict(osd)
    s2 = dist.DistributedTrainStep(m2, o2, gpt.gpt_loss, comm_options=q)
    out["resumed"] = torch.cat([fresh, torch.stack(
        [s2(*b) for b in batches[3:5]])])
    with tempfile.TemporaryDirectory() as ck:
        io.save_checkpoint(ck, 3, model=first.model,
                           optimizer=first.optimizer)
        m3 = _gpt(init)
        o3 = _adamw(m3)
        io.load_checkpoint(ck, model=m3, optimizer=o3)
        s3 = dist.DistributedTrainStep(m3, o3, gpt.gpt_loss, comm_options=q)
        out["resumed_io"] = torch.cat([fresh, torch.stack(
            [s3(*b) for b in batches[3:5]])])
    # the errors of the JAX step, and the port's for what waits
    errs = {}
    m = _gpt(init)
    from paddle_tpu_torch import amp

    errs["int8_scaler"] = _caught(lambda: dist.DistributedTrainStep(
        m, _adamw(m), gpt.gpt_loss, comm_options=q,
        scaler=amp.GradScaler()))
    mesh = dist.env.Mesh({"data": world, "model": 1}, range(world))
    errs["not_pure_dp"] = _caught(lambda: dist.DistributedTrainStep(
        m, _adamw(m), gpt.gpt_loss, mesh=mesh,
        comm_options=gradcomm.CommOptions()))
    import warnings

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        dist.DistributedTrainStep(dist.DataParallel(m, comm_buffer_size=1),
                                  _adamw(m), gpt.gpt_loss, mesh=mesh)
    errs["inherited_warns"] = [type(x.message).__name__ for x in w]
    s = dist.DistributedTrainStep(m, _adamw(m), gpt.gpt_loss,
                                  comm_options=gradcomm.CommOptions())
    ids, labels = batches[0]
    errs["indivisible"] = _caught(lambda: s(ids[:3], labels[:3]))
    acc = gradcomm.CommOptions(accumulate_steps=2)
    s = dist.DistributedTrainStep(m, _adamw(m), gpt.gpt_loss,
                                  comm_options=acc)
    errs["call_accumulate"] = _caught(lambda: s(ids, labels))
    errs["window"] = _caught(lambda: s.run_fused(batches[:3]))
    errs["shard_opt_state"] = _caught(lambda: dist.DistributedTrainStep(
        m, _adamw(m), gpt.gpt_loss, shard_opt_state=True))
    errs["model_axis"] = _caught(
        lambda: dist.init_mesh({"data": 1, "model": world}))
    errs["no_mesh"] = _caught(lambda: (dist.set_mesh(None),
                                       dist.DistributedTrainStep(
                                           m, _adamw(m), gpt.gpt_loss)))
    meta["errors"] = errs
    return out, meta


def fused(rank, world, d):
    """``run_fused`` accumulation (AdamW, and SGD with the parameters it
    leaves), fleet's ``build_train_step`` with AMP and the strategy's
    refusals."""
    import torch

    from paddle_tpu_torch import dist, fleet, optim
    from paddle_tpu_torch.dist import gradcomm
    from paddle_tpu_torch.models.nlp import gpt

    init = dict(np.load(os.path.join(d, "gpt_init.npz")))
    out, meta = {}, {}
    dist.init_mesh({"data": world})
    acc, _ = _train(init, comm=gradcomm.CommOptions(accumulate_steps=2),
                    steps=0)
    out["accumulate"] = acc.run_fused(gpt_batches())
    meta["accumulate_exchanges"] = acc.exchanges
    # the same through run_fused's own argument on the implicit step
    imp, _ = _train(init, steps=0)
    out["accumulate_kw"] = imp.run_fused(gpt_batches(), accumulate_steps=2)
    out["accumulate.params"] = torch.cat(
        [p.detach().reshape(-1) for p in acc.model.parameters()])
    out["accumulate_kw.params"] = torch.cat(
        [p.detach().reshape(-1) for p in imp.model.parameters()])
    m = _gpt(init)
    sgd = dist.DistributedTrainStep(
        m, optim.SGD(GPT_SGD_LR, parameters=m.named_parameters()),
        gpt.gpt_loss, comm_options=gradcomm.CommOptions(accumulate_steps=2))
    out["sgd"] = sgd.run_fused(gpt_batches())
    for n, t in m.state_dict().items():
        out[f"sgd.{n}"] = t
    strategy = dist.DistributedStrategy()
    strategy.amp = True
    strategy.amp_configs = {"dtype": "bfloat16", "level": "O1"}
    fleet.init(is_collective=True, strategy=strategy)
    meta["fleet"] = [fleet.worker_num(), fleet.worker_index(),
                     fleet.is_first_worker()]
    m = _gpt(init)
    opt = fleet.distributed_optimizer(_adamw(m))
    step = fleet.build_train_step(fleet.distributed_model(m), opt,
                                  gpt.gpt_loss)
    meta["fleet_scaler"] = type(step.scaler).__name__ if step.scaler \
        else None
    out["fleet_amp"] = torch.stack([step(*b) for b in gpt_batches()])
    fleet.barrier_worker()
    strategy = dist.DistributedStrategy()
    strategy.sharding = True
    fleet.init(strategy=strategy)
    meta["sharding"] = _caught(lambda: fleet.build_train_step(
        m, _adamw(m), gpt.gpt_loss))
    return out, meta


def _bn_net(init, sync):
    import torch

    from paddle_tpu_torch import nn

    norm = nn.SyncBatchNorm if sync else nn.BatchNorm2D
    net = nn.Sequential(
        nn.Conv2D(3, 4, 3, padding=1, device="cpu"),
        norm(4, device="cpu"), nn.ReLU(), nn.Flatten(),
        nn.Linear(4 * BN_BATCH[2] * BN_BATCH[3], BN_CLASSES, device="cpu"))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return net


def _bn_loss(m, x, y):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(m(x), y)


def norm(rank, world, d):
    """``SyncBatchNorm`` forward and backward on this rank's rows, and the
    conv-BN net's 4 steps under the implicit and the explicit exchange
    with BatchNorm and with SyncBatchNorm."""
    import torch

    from paddle_tpu_torch import dist, nn, optim
    from paddle_tpu_torch.dist import gradcomm

    out, meta = {}, {}
    dist.init_mesh({"data": world})
    rng = np.random.RandomState(3)
    x = rng.randn(4 * world, 4, 5, 5).astype(np.float32) * 3 + 1
    w = rng.randn(4 * world, 4, 5, 5).astype(np.float32)
    layer = nn.SyncBatchNorm(4, device="cpu")
    with torch.no_grad():
        layer.weight.copy_(torch.linspace(0.5, 2.0, 4))
        layer.bias.copy_(torch.linspace(-1.0, 1.0, 4))
    xr = torch.from_numpy(_block(x, rank, world).copy()).requires_grad_()
    y = layer(xr)
    (y * torch.from_numpy(_block(w, rank, world).copy())).sum().backward()
    out["sync.y"], out["sync.dx"] = y.detach(), xr.grad
    out["sync.dw"], out["sync.db"] = layer.weight.grad, layer.bias.grad
    out["sync.mean"], out["sync.var"] = layer._mean, layer._variance
    init = dict(np.load(os.path.join(d, "bn_init.npz")))
    for tag, sync, comm in (("bn_implicit", False, None),
                            ("bn_explicit", False, gradcomm.CommOptions()),
                            ("sync_explicit", True, gradcomm.CommOptions())):
        net = _bn_net(init, sync)
        opt = optim.SGD(BN_LR, parameters=net.named_parameters())
        step = dist.DistributedTrainStep(net, opt, _bn_loss,
                                         comm_options=comm)
        out[tag] = torch.stack([step(*b) for b in bn_batches()])
        for n, t in net.state_dict().items():
            out[f"{tag}.{n}"] = t
    return out, meta


SCENARIOS = {"collectives": collectives, "exchange": exchange,
             "train": train, "fused": fused, "norm": norm}


def _save(path, out, meta):
    import torch

    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in out.items()}
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def main(argv):
    scenario, rank, world, d = argv[0], int(argv[1]), int(argv[2]), argv[3]
    path = os.path.join(d, f"{scenario}_{world}_{rank}")
    sys.path.insert(0, REPO)
    try:
        import torch

        torch.set_num_threads(1)
        from paddle_tpu_torch import dist, set_device

        set_device("cpu")
        dist.init_parallel_env(
            init_method="file://" + os.path.join(d, f"store_{scenario}_"
                                                 f"{world}"),
            rank=rank, world_size=world)
        out, meta = SCENARIOS[scenario](rank, world, d)
        _save(path, out, meta)
        dist.env._shutdown()
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        return 1
    return 0


# -- the test side ---------------------------------------------------------


def start(scenario, world, d):
    """The ranks of ``scenario`` started (not waited for)."""
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r),
         str(world), str(d)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]


def collect(procs, scenario, world, d, timeout=240):
    """Wait for the ranks; ``[(arrays, meta)]`` in rank order. Raises
    ``RuntimeError`` with a rank's traceback when one failed."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for r, p in enumerate(procs):
        path = os.path.join(d, f"{scenario}_{world}_{r}")
        if p.returncode != 0:
            err = open(path + ".err").read() if os.path.exists(
                path + ".err") else logs[r][-3000:]
            raise RuntimeError(f"rank {r} of {scenario} failed:\n{err}")
        with np.load(path + ".npz") as z:
            arrays = dict(z)
        with open(path + ".json") as f:
            res.append((arrays, json.load(f)))
    return res


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
