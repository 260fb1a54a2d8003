"""Synthetic federated datasets with controlled feature-heat dispersion.

Pure numpy, bit-identical to ``repro/data/synthetic.py`` for the same seed:
each generator consumes its ``np.random.default_rng(seed)`` stream in the
same order. MovieLens, Sent140 and Amazon/Alibaba are reproduced as
statistically matched synthetics: client counts and samples per client
follow the published datasets, feature popularity is Zipf-distributed, and
labels come from a planted latent model.

Where the reference draws with ``rng.choice(n, size, p=p)``, which rebuilds
the CDF of ``p`` on every call, the port builds each distribution's CDF once
and draws with ``_draw``: the same ``rng.random`` and ``searchsorted`` that
``Generator.choice`` runs, so the ids are bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.core.heat import HeatStats


@dataclass
class FederatedDataset:
    name: str
    task: str                       # lr | lstm | din | lm
    num_clients: int
    num_features: int
    client_data: Dict[str, np.ndarray]    # leaves (N, max_samples, ...)
    sample_counts: np.ndarray             # (N,)
    heat: HeatStats
    test_data: Dict[str, np.ndarray]
    feature_key: str = "features"         # which leaf carries feature ids

    def stats(self) -> Dict:
        return {
            "clients": self.num_clients,
            "samples": int(self.sample_counts.sum()),
            "samples_per_client": float(self.sample_counts.mean()),
            "dispersion": self.heat.dispersion(),
            "coverage": self.heat.coverage(),
        }


def _zipf_probs(n: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def _pad_stack(rows, max_len, fill=0):
    out = np.full((len(rows), max_len) + rows[0].shape[1:], fill, dtype=rows[0].dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r[:max_len]
    return out


def _cdf(p: np.ndarray) -> np.ndarray:
    """The CDF ``Generator.choice`` builds from ``p``."""
    cdf = p.cumsum()
    cdf /= cdf[-1]
    return cdf


def _draw(rng: np.random.Generator, cdf: np.ndarray, size) -> np.ndarray:
    """``rng.choice(len(cdf), size, p=p)`` given ``cdf = _cdf(p)``."""
    return cdf.searchsorted(rng.random(size), side="right")


def _heat_from_ids(per_client_ids, num_features) -> HeatStats:
    counts = np.zeros(num_features, np.float64)
    for ids in per_client_ids:
        u = np.unique(ids[ids >= 0])
        counts[u] += 1
    return HeatStats(counts=counts, total=float(len(per_client_ids)))


def make_movielens_like(num_clients: int = 300, num_items: int = 200,
                        mean_samples: int = 40, zipf_a: float = 1.2,
                        seed: int = 0, test_frac: float = 0.2) -> FederatedDataset:
    """LR over one-hot(gender, age, movie, gender x movie, age x movie).

    ``num_features = 9 + 10 * num_items``. MovieLens-1M's published size is
    6,040 users and 3,706 rated movies with about 1.0M ratings
    (``mean_samples=165``), which gives 37,069 features.
    """
    rng = np.random.default_rng(seed)
    m = num_items
    num_features = 9 + 10 * m       # 2 gender + 7 age + M + 2M + 7M
    pop_cdf = _cdf(_zipf_probs(m, zipf_a))

    q = rng.normal(0, 1.2, m)                       # movie quality
    g_aff = rng.normal(0, 0.5, (2, m))              # gender x movie affinity
    a_aff = rng.normal(0, 0.5, (7, m))              # age x movie affinity

    feats, labels, counts = [], [], []
    test_feats, test_labels = [], []
    for _ in range(num_clients):
        g = rng.integers(0, 2)
        a = rng.integers(0, 7)
        n = max(5, int(rng.poisson(mean_samples)))
        movies = _draw(rng, pop_cdf, n)
        logit = q[movies] + g_aff[g, movies] + a_aff[a, movies] + rng.normal(0, 0.5, n)
        lab = (logit > 0).astype(np.int32)
        f = np.stack([
            np.full(n, g),
            np.full(n, 2 + a),
            9 + movies,
            9 + m + g * m + movies,
            9 + 3 * m + a * m + movies,
        ], axis=1).astype(np.int32)
        n_test = max(1, int(n * test_frac))
        test_feats.append(f[:n_test])
        test_labels.append(lab[:n_test])
        feats.append(f[n_test:])
        labels.append(lab[n_test:])
        counts.append(n - n_test)

    max_len = max(counts)
    data = {
        "features": _pad_stack(feats, max_len, fill=-1),
        "label": _pad_stack(labels, max_len, fill=0),
    }
    heat = _heat_from_ids([f.reshape(-1) for f in feats], num_features)
    return FederatedDataset(
        name="movielens_like", task="lr", num_clients=num_clients,
        num_features=num_features, client_data=data,
        sample_counts=np.array(counts), heat=heat,
        test_data={"features": np.concatenate(test_feats),
                   "label": np.concatenate(test_labels)},
    )


def make_sent140_like(num_clients: int = 200, vocab: int = 2000, seq_len: int = 24,
                      mean_samples: int = 30, zipf_a: float = 1.1,
                      seed: int = 0, test_frac: float = 0.2) -> FederatedDataset:
    """LSTM sentiment over Zipf token streams: each client skews towards a
    personal topic slice of the vocabulary; a sample's label is the sign of
    its words' planted polarity plus noise. Tokens pad with -1."""
    rng = np.random.default_rng(seed)
    pop = _zipf_probs(vocab, zipf_a)
    pop_cdf = _cdf(pop)
    sentiment = rng.normal(0, 1.0, vocab)           # planted word polarity

    toks, labels, counts, t_toks, t_labels = [], [], [], [], []
    for _ in range(num_clients):
        n = max(5, int(rng.poisson(mean_samples)))
        boost = np.zeros(vocab)
        topic = _draw(rng, pop_cdf, 20)
        boost[topic] += 3.0
        p = pop * np.exp(boost * 0.2)
        p /= p.sum()
        cdf = _cdf(p)
        lens = rng.integers(6, seq_len + 1, n)
        seqs = np.full((n, seq_len), -1, np.int32)
        lab = np.zeros(n, np.int32)
        for j in range(n):
            s = _draw(rng, cdf, lens[j])
            seqs[j, : lens[j]] = s
            score = sentiment[s].mean() + rng.normal(0, 0.3)
            lab[j] = int(score > 0)
        n_test = max(1, int(n * test_frac))
        t_toks.append(seqs[:n_test])
        t_labels.append(lab[:n_test])
        toks.append(seqs[n_test:])
        labels.append(lab[n_test:])
        counts.append(n - n_test)

    max_len = max(counts)
    data = {
        "tokens": _pad_stack(toks, max_len, fill=-1),
        "label": _pad_stack(labels, max_len, fill=0),
    }
    heat = _heat_from_ids([t.reshape(-1) for t in toks], vocab)
    return FederatedDataset(
        name="sent140_like", task="lstm", num_clients=num_clients,
        num_features=vocab, client_data=data, sample_counts=np.array(counts),
        heat=heat,
        test_data={"tokens": np.concatenate(t_toks), "label": np.concatenate(t_labels)},
        feature_key="tokens",
    )


def make_amazon_like(num_clients: int = 250, num_items: int = 500, hist_len: int = 10,
                     mean_samples: int = 40, zipf_a: float = 1.05, emb_rank: int = 8,
                     seed: int = 0, test_frac: float = 0.2) -> FederatedDataset:
    """DIN CTR with behaviour histories: a user's history is drawn from its
    interest pool, its targets half from the pool and half by popularity.

    ``hist`` pads with -1, ``target`` with 0 (a padded sample is never
    drawn), and the heat counts history and target ids together. The DIN
    paper's Amazon Electronics has 192,403 users, 63,001 goods and
    1,689,188 samples (``num_items=63001, mean_samples=9``).
    """
    rng = np.random.default_rng(seed)
    pop = _zipf_probs(num_items, zipf_a)
    item_vec = rng.normal(0, 1.0 / np.sqrt(emb_rank), (num_items, emb_rank))

    hists, targets, labels, counts = [], [], [], []
    t_h, t_t, t_l = [], [], []
    for _ in range(num_clients):
        u = rng.normal(0, 1.0, emb_rank)
        n = max(5, int(rng.poisson(mean_samples)))
        aff = item_vec @ u                            # the user's interest pool
        p = pop * np.exp(aff - aff.max())
        p = p / p.sum()
        cdf = _cdf(p)
        hist = np.full((n, hist_len), -1, np.int32)
        tgt = _draw(rng, _cdf(0.5 * pop + 0.5 * p), n)
        lab = np.zeros(n, np.int32)
        for j in range(n):
            hl = rng.integers(3, hist_len + 1)
            h = _draw(rng, cdf, hl)
            hist[j, :hl] = h
            match = item_vec[h] @ item_vec[tgt[j]]
            lab[j] = int(u @ item_vec[tgt[j]] + match.mean() + rng.normal(0, 0.4) > 0)
        n_test = max(1, int(n * test_frac))
        t_h.append(hist[:n_test])
        t_t.append(tgt[:n_test])
        t_l.append(lab[:n_test])
        hists.append(hist[n_test:])
        targets.append(tgt[n_test:].astype(np.int32))
        labels.append(lab[n_test:])
        counts.append(n - n_test)

    max_len = max(counts)
    data = {
        "hist": _pad_stack(hists, max_len, fill=-1),
        "target": _pad_stack(targets, max_len, fill=0),
        "label": _pad_stack(labels, max_len, fill=0),
    }
    ids = [np.concatenate([h.reshape(-1), t]) for h, t in zip(hists, targets)]
    heat = _heat_from_ids(ids, num_items)
    return FederatedDataset(
        name="amazon_like", task="din", num_clients=num_clients,
        num_features=num_items, client_data=data, sample_counts=np.array(counts),
        heat=heat,
        test_data={"hist": np.concatenate(t_h), "target": np.concatenate(t_t),
                   "label": np.concatenate(t_l)},
        feature_key="hist",
    )


def make_alibaba_like(**kw) -> FederatedDataset:
    """Alibaba-industrial-like: the DIN task with higher dispersion and more
    clients."""
    kw.setdefault("num_clients", 500)
    kw.setdefault("num_items", 1500)
    kw.setdefault("zipf_a", 1.35)
    kw.setdefault("seed", 1)
    ds = make_amazon_like(**kw)
    ds.name = "alibaba_like"
    return ds


#: the ported generators by the reference's dataset names (its "lm" corpus
#: is not ported)
DATASETS = {
    "movielens": make_movielens_like,
    "sent140": make_sent140_like,
    "amazon": make_amazon_like,
    "alibaba": make_alibaba_like,
}
