"""The recommender nets, the counterparts of
``paddle_tpu/models/rec/recommender.py``'s (the reference's book chapter
5, ``test_recommender_system.py``): the two-tower matcher
(``TwoTowerRecommender``: user and movie towers, 5 x their cosine
similarity as the rating, ``rating_loss``) and the DeepFM ranker
(first-order weights, the factorisation machine's pairwise term and a
deep MLP over one embedding a field). A ``LayerList`` of the JAX model
is an ``nn.LayerList`` here, so a state dict names ``embeds.0.weight``
as the JAX one does."""
from __future__ import annotations

from ...nn.layer import Layer, LayerList
from ..._device import resolve_device
from ... import ops
from ...nn import functional as F
from ...nn.layers.common import Embedding, Linear

__all__ = ["TwoTowerRecommender", "DeepFM", "rating_loss"]


class TwoTowerRecommender(Layer):
    """Dual-tower matching model; score = 5 * cos_sim(user, item)."""

    def __init__(self, n_users, n_items, n_genders=2, n_ages=7, n_jobs=21,
                 n_categories=19, embed_dim=32, hidden=200, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.u_id = Embedding(n_users, embed_dim, **kw)
        self.u_gender = Embedding(n_genders, 16, **kw)
        self.u_age = Embedding(n_ages, 16, **kw)
        self.u_job = Embedding(n_jobs, 16, **kw)
        self.u_fc = Linear(embed_dim + 48, hidden, **kw)
        self.i_id = Embedding(n_items, embed_dim, **kw)
        self.i_cat = Embedding(n_categories, embed_dim, **kw)
        self.i_fc = Linear(2 * embed_dim, hidden, **kw)

    def user_tower(self, uid, gender, age, job):
        h = ops.concat([self.u_id(uid), self.u_gender(gender),
                        self.u_age(age), self.u_job(job)], axis=-1)
        return F.tanh(self.u_fc(h))

    def item_tower(self, iid, cat):
        h = ops.concat([self.i_id(iid), self.i_cat(cat)], axis=-1)
        return F.tanh(self.i_fc(h))

    def forward(self, uid, gender, age, job, iid, cat):
        u = self.user_tower(uid, gender, age, job)
        i = self.item_tower(iid, cat)
        return 5.0 * F.cosine_similarity(u, i, axis=-1)


class DeepFM(Layer):
    """FM second-order interactions + deep MLP over shared embeddings.
    ``fields``: the vocabulary size of each field, one sparse feature a
    field; one (B,) id tensor a field -> (B,) logits."""

    def __init__(self, fields, embed_dim=16, hidden=(400, 400, 400),
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.embeds = LayerList([Embedding(v, embed_dim, **kw)
                                 for v in fields])
        self.linears = LayerList([Embedding(v, 1, **kw) for v in fields])
        dims = [len(fields) * embed_dim] + list(hidden)
        self.mlp = LayerList([Linear(dims[i], dims[i + 1], **kw)
                              for i in range(len(hidden))])
        self.out = Linear(dims[-1], 1, **kw)

    def forward(self, *field_ids):
        vs = [emb(ids) for emb, ids in zip(self.embeds, field_ids)]  # (B,E)
        first = ops.concat([lin(ids) for lin, ids in
                            zip(self.linears, field_ids)], axis=-1)
        first = ops.sum(first, axis=-1)                      # (B,)
        V = ops.stack(vs, axis=1)                            # (B, F, E)
        sum_sq = ops.sum(V, axis=1) ** 2                     # (B, E)
        sq_sum = ops.sum(V * V, axis=1)
        fm = 0.5 * ops.sum(sum_sq - sq_sum, axis=-1)         # (B,)
        h = ops.reshape(V, [V.shape[0], -1])
        for fc in self.mlp:
            h = F.relu(fc(h))
        deep = ops.squeeze(self.out(h), -1)
        return first + fm + deep


def rating_loss(model, uid, gender, age, job, iid, cat, rating):
    """The squared error of the two-tower model's rating."""
    return F.mse_loss(model(uid, gender, age, job, iid, cat), rating)
