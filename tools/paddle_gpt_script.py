"""A Paddle training script, written once against a package handle ``m``.

``m`` is ``paddle_tpu`` or ``paddle_tpu_torch``: the script uses only
the Paddle user surface both export, the way a user writes it —
``m.set_device``, a ``Block(m.nn.Layer)`` whose attention projections
come from ``self.create_parameter``, ``m.nn.LayerNorm``, causal
``m.nn.functional.scaled_dot_product_attention``, an ``m.nn.LayerList``
of blocks, a head tied to the token embedding,
``m.nn.functional.cross_entropy``, ``m.to_tensor``, ``m.optim.AdamW``,
``m.TrainStep``, ``m.save``/``m.load`` with ``set_state_dict``, and
``m.to_static``. ``methods=True`` spells the same model and loss in
method form, the way most Paddle scripts are written: each functional
call as its ``Tensor`` method (``m.reshape(t, s)`` as ``t.reshape(s)``,
``m.matmul(a, b, transpose_y=True)`` as ``a.matmul(b,
transpose_y=True)``), plus the surface that computes nothing
(``B, L = x.shape[:2]``, ``labels.astype("int64")`` of int64 labels,
``ids.stop_gradient``, ``loss.numpy()`` for the log,
``opt.clear_grad()`` and ``p.clear_grad()``). It makes the same
parameters, under the same names and in the same order, and runs the
same ops: the two forms give the same bits. At ``CONFIGS["bench_gpt"]``
it is ``bench.py``'s bench_gpt model (``gpt_small``'s widths: 12
layers, 12 heads x 64, L 1024, vocab 50304), trained in bfloat16
(``model.bfloat16()``) with ``multi_precision`` AdamW; at
``CONFIGS["tiny"]`` it is small enough for the CPU.

It imports neither package itself; the caller passes one:

    import paddle_tpu_torch as m
    cfg = CONFIGS["tiny"]
    m.set_device("cpu")
    model = make_model(m, cfg)
    losses, opt = train(m, model, batches(cfg, steps=8), cfg)

or, in method form, ``make_model(m, cfg, methods=True)`` and
``train(m, model, data, cfg, methods=True)``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CONFIGS", "make_model", "loss_fn", "batches", "train",
           "save_and_load", "static_forward"]

CONFIGS = {
    # bench.py:187-210 (gpt_small at dropout 0, bf16, batch 16 x 1024)
    "bench_gpt": dict(vocab=50304, hidden=768, heads=12, layers=12,
                      max_len=1024, ffn=3072, batch=16, seq=1024,
                      dtype="bfloat16", lr=3e-4),
    "tiny": dict(vocab=256, hidden=128, heads=2, layers=2, max_len=128,
                 ffn=512, batch=2, seq=128, dtype="float32", lr=3e-3),
}


def make_model(m, cfg, methods=False):
    """The model of ``cfg``, made on the current place; its forwards in
    method form with ``methods``."""
    nn, F = m.nn, m.nn.functional
    H, nh = cfg["hidden"], cfg["heads"]
    small = m.ParamAttr(initializer=nn.initializer.Normal(0.0, 0.02))

    class Block(nn.Layer):
        """Pre-LN attention and MLP, each with its residual."""

        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(H)
            self.ln2 = nn.LayerNorm(H)
            self.wq = self.create_parameter([H, H])
            self.wk = self.create_parameter([H, H])
            self.wv = self.create_parameter([H, H])
            self.wo = self.create_parameter([H, H])
            self.bq = self.create_parameter([H], is_bias=True)
            self.bk = self.create_parameter([H], is_bias=True)
            self.bv = self.create_parameter([H], is_bias=True)
            self.bo = self.create_parameter([H], is_bias=True)
            self.fc1 = nn.Linear(H, cfg["ffn"])
            self.fc2 = nn.Linear(cfg["ffn"], H)

        def forward(self, x):
            B, L = x.shape[0], x.shape[1]
            h = self.ln1(x)
            heads = [B, L, nh, H // nh]
            q = m.reshape(m.matmul(h, self.wq) + self.bq, heads)
            k = m.reshape(m.matmul(h, self.wk) + self.bk, heads)
            v = m.reshape(m.matmul(h, self.wv) + self.bv, heads)
            a = F.scaled_dot_product_attention(q, k, v, dropout_p=0.0,
                                               is_causal=True)
            x = x + m.matmul(m.reshape(a, [B, L, H]), self.wo) + self.bo
            return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))

    class MethodBlock(Block):
        """``Block`` with its forward in method form."""

        def forward(self, x):
            B, L = x.shape[:2]
            h = self.ln1(x)
            heads = [B, L, nh, H // nh]
            q = (h.matmul(self.wq) + self.bq).reshape(heads)
            k = (h.matmul(self.wk) + self.bk).reshape(heads)
            v = (h.matmul(self.wv) + self.bv).reshape(heads)
            a = F.scaled_dot_product_attention(q, k, v, dropout_p=0.0,
                                               is_causal=True)
            x = x + a.reshape([B, L, H]).matmul(self.wo) + self.bo
            return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))

    class GPTScript(nn.Layer):
        """Token and position embeddings, the blocks, a final LayerNorm
        and the head tied to the token embedding."""

        def __init__(self):
            super().__init__()
            self.wte = nn.Embedding(cfg["vocab"], H, weight_attr=small)
            self.wpe = self.create_parameter(
                [cfg["max_len"], H], default_initializer=nn.initializer
                .Normal(0.0, 0.02))
            self.blocks = nn.LayerList([(MethodBlock if methods else Block)()
                                        for _ in range(cfg["layers"])])
            self.ln_f = nn.LayerNorm(H)

        def forward(self, ids):
            x = self.wte(ids) + self.wpe[:ids.shape[1]]
            for block in self.blocks:
                x = block(x)
            return m.matmul(self.ln_f(x), self.wte.weight, transpose_y=True)

    class MethodGPTScript(GPTScript):
        """``GPTScript`` with its forward in method form."""

        def forward(self, ids):
            assert ids.stop_gradient
            L = ids.shape[1]
            x = self.wte(ids) + self.wpe[:L]
            for block in self.blocks:
                x = block(x)
            return self.ln_f(x).matmul(self.wte.weight, transpose_y=True)

    model = (MethodGPTScript if methods else GPTScript)()
    if cfg["dtype"] == "bfloat16":
        model.bfloat16()
    return model


def loss_fn(m, model, ids, labels, methods=False):
    logits = model(ids)
    V = logits.shape[-1]
    if methods:
        return m.nn.functional.cross_entropy(
            logits.reshape([-1, V]), labels.astype("int64").reshape([-1]))
    return m.nn.functional.cross_entropy(m.reshape(logits, [-1, V]),
                                         m.reshape(labels, [-1]))


def batches(cfg, steps, seed=0):
    """``steps`` (ids, labels) pairs of int64 arrays, from ``seed``."""
    rng = np.random.RandomState(seed)
    shape = (cfg["batch"], cfg["seq"])
    return [(rng.randint(0, cfg["vocab"], shape).astype(np.int64),
             rng.randint(0, cfg["vocab"], shape).astype(np.int64))
            for _ in range(steps)]


def train(m, model, data, cfg, step=None, methods=False):
    """AdamW (``multi_precision``) over ``data`` through ``m.TrainStep``
    (or ``step``, to go on with one): the losses as floats, and the
    step; the loss in method form with ``methods``, each step's loss
    read back with ``loss.numpy()``."""
    if step is None:
        opt = m.optim.AdamW(learning_rate=cfg["lr"],
                            parameters=model.parameters(),
                            multi_precision=True)
        step = m.TrainStep(
            model, opt,
            lambda mdl, x, y: loss_fn(m, mdl, x, y, methods=methods))
        if methods:
            opt.clear_grad()
            for p in model.parameters():
                p.clear_grad()
    if methods:
        return [float(step(m.to_tensor(x), m.to_tensor(y)).numpy())
                for x, y in data], step
    losses = [float(step(m.to_tensor(x), m.to_tensor(y))) for x, y in data]
    return losses, step


def save_and_load(m, model, path, fresh):
    """``model``'s state dict saved to ``path`` and loaded into
    ``fresh``: ``set_state_dict``'s ``(missing, unexpected)``."""
    m.save(model.state_dict(), path)
    return fresh.set_state_dict(m.load(path))


def static_forward(m, model, ids):
    """``m.to_static(model)`` in eval mode, called on ``ids``: the
    static function and its logits."""
    model.eval()
    fn = m.to_static(model)
    return fn, fn(m.to_tensor(ids))
