"""Recsys model zoo: DLRM-RM2, two-tower retrieval, xDeepFM (CIN), MIND
(mirror of ``repro.models.recsys``).

Shared substrate: large stacked embedding tables (``StackedTables``) with
EmbeddingBag lookups (gather + segment sum), feature-interaction ops (dot
/ CIN / multi-interest capsule routing), small dense MLPs.  Parameters are
nested dicts and lists of tensors, as the reference's pytrees, so the
port's ``make_train_step``, ``adamw_update`` and checkpoints take them.

``*_score_candidates`` implements the ``retrieval_cand`` shape: one query
scored against 10^6 candidates as a batched dot / batched forward -- never
a loop.  Top-k is ``retrieval.exact.top_k``: a stable descending sort, so
tied scores keep the lower index first, as ``jax.lax.top_k`` does.

The BCE loss is written out as the reference writes it (not
``binary_cross_entropy_with_logits``); ``torch.maximum`` splits the
gradient of a tie at 0 in half, as ``jnp.maximum`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed import hints
from repro_torch.models.common import trunc_normal
from repro_torch.models.embedding import (StackedTables, embedding_bag,
                                          init_device, mlp_apply, mlp_init,
                                          take)
from repro_torch.retrieval.exact import top_k as _top_k


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    y = labels.float()
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def _in_batch_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp minus the diagonal (gold) logit."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.diagonal(logits)
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# DLRM  [arXiv:1906.00091]  (RM2 scale: 26 sparse, dot interaction)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_per_field: int = 1_000_000
    bot_mlp: tuple[int, ...] = (512, 256, 64)
    top_mlp: tuple[int, ...] = (512, 512, 256, 1)

    def tables(self) -> StackedTables:
        return StackedTables((self.vocab_per_field,) * self.n_sparse,
                             self.embed_dim)

    @property
    def n_feat(self) -> int:
        return self.n_sparse + 1  # + bottom-MLP output

    @property
    def interaction_dim(self) -> int:
        n = self.n_feat
        return n * (n - 1) // 2 + self.bot_mlp[-1]


def dlrm_init(generator: torch.Generator, cfg: DLRMConfig,
              dtype=torch.float32, device=None) -> dict:
    device = init_device(generator, device)
    return {
        "tables": cfg.tables().init(generator, dtype, device),
        "bot": mlp_init(generator, (cfg.n_dense,) + cfg.bot_mlp, dtype,
                        device),
        "top": mlp_init(generator, (cfg.interaction_dim,) + cfg.top_mlp,
                        dtype, device),
    }


def _dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """feats: (B, n, d) -> lower-triangular pairwise dots (B, n(n-1)/2),
    in ``np.tril_indices(n, k=-1)``'s row-major order."""
    n = feats.shape[1]
    z = torch.einsum("bnd,bmd->bnm", feats, feats)
    iu, ju = torch.tril_indices(n, n, offset=-1, device=feats.device)
    return z[:, iu, ju]


def dlrm_forward(params: dict, dense: torch.Tensor, sparse: torch.Tensor,
                 cfg: DLRMConfig) -> torch.Tensor:
    """dense: (B, n_dense) float; sparse: (B, n_sparse) int -> (B,) logits."""
    bot = mlp_apply(params["bot"], dense, final_act=True)        # (B, d)
    emb = cfg.tables().lookup(params["tables"], sparse)  # (B, n_sparse, d)
    feats = torch.cat([bot[:, None, :], emb], dim=1)
    inter = _dot_interaction(feats)
    top_in = torch.cat([bot, inter], dim=-1)
    return mlp_apply(params["top"], top_in)[:, 0]


def dlrm_loss(params: dict, batch: dict, cfg: DLRMConfig) -> torch.Tensor:
    logits = dlrm_forward(params, batch["dense"], batch["sparse"], cfg)
    return _bce(logits, batch["labels"])


def _with_candidates(row: torch.Tensor, candidate_ids: torch.Tensor,
                     item_field: int) -> torch.Tensor:
    """``row`` (1, F) broadcast to one row a candidate, column
    ``item_field`` set to the candidate ids."""
    out = row.expand(candidate_ids.shape[0], row.shape[-1]).clone()
    out[:, item_field] = candidate_ids.to(out.dtype)
    return out


def dlrm_score_candidates(params: dict, dense: torch.Tensor,
                          sparse: torch.Tensor, candidate_ids: torch.Tensor,
                          cfg: DLRMConfig,
                          item_field: int = 0) -> torch.Tensor:
    """One user (dense (1,13), sparse (1,26)) against (n_cand,) item ids:
    broadcast the user and vary ``item_field`` -> (n_cand,) scores."""
    n = candidate_ids.shape[0]
    dense_b = dense.expand(n, cfg.n_dense)
    sparse_b = _with_candidates(sparse, candidate_ids, item_field)
    return dlrm_forward(params, dense_b, sparse_b, cfg)


# ---------------------------------------------------------------------------
# Two-tower retrieval  [Yi et al., RecSys'19]
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: tuple[int, ...] = (1024, 512, 256)
    n_users: int = 1_000_000
    n_items: int = 2_000_000
    hist_len: int = 50
    temperature: float = 0.05


def two_tower_init(generator: torch.Generator, cfg: TwoTowerConfig,
                   dtype=torch.float32, device=None) -> dict:
    device = init_device(generator, device)
    d = cfg.embed_dim
    return {
        "user_table": StackedTables((cfg.n_users,), d).init(
            generator, dtype, device),
        "item_table": StackedTables((cfg.n_items,), d).init(
            generator, dtype, device),
        "user_mlp": mlp_init(generator, (2 * d,) + cfg.tower_mlp, dtype,
                             device),
        "item_mlp": mlp_init(generator, (d,) + cfg.tower_mlp, dtype, device),
    }


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)


def user_tower(params: dict, user_ids: torch.Tensor, hist_ids: torch.Tensor,
               cfg: TwoTowerConfig) -> torch.Tensor:
    """user_ids: (B,); hist_ids: (B, T) item-id history (bag-mean)."""
    b, t = hist_ids.shape
    u = take(params["user_table"], user_ids)
    seg = torch.arange(b, device=hist_ids.device).repeat_interleave(t)
    hist = embedding_bag(params["item_table"], hist_ids.reshape(-1), seg, b,
                         mode="mean")
    return _unit(mlp_apply(params["user_mlp"], torch.cat([u, hist], -1)))


def item_tower(params: dict, item_ids: torch.Tensor,
               cfg: TwoTowerConfig) -> torch.Tensor:
    e = take(params["item_table"], item_ids)
    return _unit(mlp_apply(params["item_mlp"], e))


def two_tower_loss(params: dict, batch: dict,
                   cfg: TwoTowerConfig) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction."""
    q = user_tower(params, batch["user_ids"], batch["hist_ids"], cfg)
    v = item_tower(params, batch["item_ids"], cfg)
    logits = (q @ v.T) / cfg.temperature
    log_q = batch.get("log_q")
    if log_q is not None:
        logits = logits - log_q[None, :]
    return _in_batch_softmax(logits)


def two_tower_score_candidates(params: dict, user_ids: torch.Tensor,
                               hist_ids: torch.Tensor,
                               candidate_ids: torch.Tensor,
                               cfg: TwoTowerConfig, top_k: int = 100):
    q = user_tower(params, user_ids, hist_ids, cfg)          # (1, d)
    v = item_tower(params, candidate_ids, cfg)               # (N, d)
    scores = (v @ q[0]) / cfg.temperature                    # (N,)
    return _top_k(scores, top_k)


# ---------------------------------------------------------------------------
# xDeepFM  [arXiv:1803.05170]  (CIN interaction)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 1_000_000
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp: tuple[int, ...] = (400, 400)

    def tables(self) -> StackedTables:
        return StackedTables((self.vocab_per_field,) * self.n_sparse,
                             self.embed_dim)

    def linear_tables(self) -> StackedTables:
        """The dim-1 table of the linear term, one row per (field, id)."""
        return StackedTables((self.vocab_per_field,) * self.n_sparse, 1)


def xdeepfm_init(generator: torch.Generator, cfg: XDeepFMConfig,
                 dtype=torch.float32, device=None) -> dict:
    device = init_device(generator, device)
    m = cfg.n_sparse
    cin_w = []
    h_prev = m
    for h in cfg.cin_layers:
        w = trunc_normal((h, h_prev, m), generator, device) / (
            (h_prev * m) ** 0.5)
        cin_w.append(w.to(dtype))
        h_prev = h
    return {
        "tables": cfg.tables().init(generator, dtype, device),
        "linear": cfg.linear_tables().init(generator, dtype, device),
        "cin": cin_w,
        "cin_out": mlp_init(generator, (sum(cfg.cin_layers), 1), dtype,
                            device),
        "deep": mlp_init(generator, (m * cfg.embed_dim,) + cfg.mlp + (1,),
                         dtype, device),
    }


def xdeepfm_forward(params: dict, sparse: torch.Tensor,
                    cfg: XDeepFMConfig) -> torch.Tensor:
    """sparse: (B, n_sparse) -> (B,) logits."""
    # the "cin_in" hint shards a DTensor lookup as its rows: the CIN's
    # einsums on any other placement cost DTensor minutes to plan
    x0 = hints.constrain(cfg.tables().lookup(params["tables"], sparse),
                         "cin_in")                            # (B, m, D)
    # CIN: x_{k} = W_k . (x_{k-1} (outer) x_0), feature-map-wise
    xs, pooled = x0, []
    for w in params["cin"]:
        z = torch.einsum("bhd,bmd->bhmd", xs, x0)
        xs = torch.einsum("bhmd,nhm->bnd", z, w)
        pooled.append(xs.sum(dim=-1))                         # (B, H_k)
    cin_term = mlp_apply(params["cin_out"], torch.cat(pooled, -1))[:, 0]
    deep_term = mlp_apply(params["deep"],
                          x0.reshape(x0.shape[0], -1))[:, 0]
    linear_term = cfg.linear_tables().lookup(
        params["linear"], sparse)[..., 0].sum(-1)
    return cin_term + deep_term + linear_term


def xdeepfm_loss(params: dict, batch: dict,
                 cfg: XDeepFMConfig) -> torch.Tensor:
    logits = xdeepfm_forward(params, batch["sparse"], cfg)
    return _bce(logits, batch["labels"])


def xdeepfm_score_candidates(params: dict, sparse: torch.Tensor,
                             candidate_ids: torch.Tensor, cfg: XDeepFMConfig,
                             item_field: int = 0) -> torch.Tensor:
    sp = _with_candidates(sparse, candidate_ids, item_field)
    return xdeepfm_forward(params, sp, cfg)


# ---------------------------------------------------------------------------
# MIND  [arXiv:1904.08030]  (multi-interest dynamic routing)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    n_items: int = 1_000_000
    hist_len: int = 50
    label_pow: float = 2.0


def mind_init(generator: torch.Generator, cfg: MINDConfig,
              dtype=torch.float32, device=None) -> dict:
    device = init_device(generator, device)
    d = cfg.embed_dim
    routing = torch.randn((cfg.n_interests, cfg.hist_len),
                          generator=generator, device=device) * 0.1
    return {
        "item_table": StackedTables((cfg.n_items,), d).init(
            generator, dtype, device),
        "bilinear": (trunc_normal((d, d), generator, device)
                     / d ** 0.5).to(dtype),
        # fixed routing-logit init (paper: random, not learned per-step)
        "routing_init": routing.to(dtype),
    }


def _squash(x: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(x * x, -1, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def mind_interests(params: dict, hist_ids: torch.Tensor,
                   cfg: MINDConfig) -> torch.Tensor:
    """hist_ids: (B, T) -> (B, K, D) interest capsules (B2I dynamic
    routing).  The routing logits' init and the low-level capsules in the
    routing update are detached, as the reference's ``stop_gradient``s:
    ``routing_init`` gets a zero gradient."""
    e = take(params["item_table"], hist_ids)                   # (B, T, D)
    el = torch.einsum("btd,de->bte", e, params["bilinear"])    # low-level caps
    b = params["routing_init"][None].expand(
        e.shape[0], cfg.n_interests, cfg.hist_len).detach()
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=1)                     # over K interests
        z = torch.einsum("bkt,bte->bke", w, el)
        u = _squash(z)
        b = b + torch.einsum("bke,bte->bkt", u, el.detach())
    return u


def mind_loss(params: dict, batch: dict, cfg: MINDConfig) -> torch.Tensor:
    """Label-aware attention + in-batch sampled softmax."""
    interests = mind_interests(params, batch["hist_ids"], cfg)  # (B, K, D)
    target = take(params["item_table"], batch["item_ids"])
    att = torch.einsum("bkd,bd->bk", interests, target)
    att = torch.softmax(cfg.label_pow * att, dim=-1)
    user_vec = torch.einsum("bk,bkd->bd", att, interests)
    return _in_batch_softmax(user_vec @ target.T)


def mind_score_candidates(params: dict, hist_ids: torch.Tensor,
                          candidate_ids: torch.Tensor, cfg: MINDConfig,
                          top_k: int = 100):
    """Max-over-interests scoring of (n_cand,) candidates for one user."""
    interests = mind_interests(params, hist_ids, cfg)           # (1, K, D)
    cand = take(params["item_table"], candidate_ids)            # (N, D)
    scores = torch.einsum("kd,nd->kn", interests[0], cand).amax(dim=0)
    return _top_k(scores, top_k)

