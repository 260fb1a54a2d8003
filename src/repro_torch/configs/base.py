"""Federated-optimization configuration (paper Algorithm 1), stdlib only.

Port of ``repro/configs/base.py::FedConfig`` with the same fields, defaults
and construction-time validation. ``ModelConfig`` and the LLM registry are
not ported yet (ROADMAP Queue 1, LLM slice).
"""
from __future__ import annotations

from dataclasses import dataclass

#: server-side algorithms
SERVER_ALGORITHMS = ("fedavg", "fedprox", "scaffold", "fedadam", "fedsubavg",
                     "central")
#: heat estimators (paper App. F)
HEAT_ESTIMATORS = ("exact", "secure_agg", "randomized_response")
#: sparse local-training replica layouts (see ``FedConfig.sparse_local``)
SPARSE_LOCAL_MODES = ("auto", "replicated", "sparse_replicated")


@dataclass(frozen=True)
class FedConfig:
    num_clients: int = 100           # N
    clients_per_round: int = 10      # K
    local_iters: int = 1             # I
    local_batch: int = 8
    microbatches: int = 1            # grad-accumulation steps per round (fedsgd)
    lr: float = 0.1                  # gamma
    server_lr: float = 1.0
    algorithm: str = "fedsubavg"     # fedavg|fedprox|scaffold|fedadam|fedsubavg|central
    prox_mu: float = 0.01            # FedProx proximal coefficient
    server_beta1: float = 0.9        # FedAdam
    server_beta2: float = 0.99
    server_eps: float = 1e-3
    weighted: bool = False           # App. D.4 weighted generalisation
    heat_estimator: str = "exact"    # exact | secure_agg | randomized_response
    rr_flip_prob: float = 0.1        # randomized-response flip probability
    seed: int = 0

    # --- sparse submodel update plane (repro_torch.sparse) ---
    sparse: bool = False             # row-sparse client deltas + sparse server agg
    sparse_topk: int = 0             # >0: per-client top-k row sparsification
    sparse_int8: bool = False        # int8 row payloads (not ported yet)
    # "sparse_replicated": each client's replica is its gathered submodel;
    # "replicated": K dense replicas; "auto": sparse_replicated whenever the
    # model's axis-0 feature tables span the dataset's id space
    sparse_local: str = "auto"

    def __post_init__(self):
        if self.algorithm not in SERVER_ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}: expected one of "
                f"{SERVER_ALGORITHMS}")
        if self.heat_estimator not in HEAT_ESTIMATORS:
            raise ValueError(
                f"unknown heat_estimator {self.heat_estimator!r}: expected "
                f"one of {HEAT_ESTIMATORS}")
        if self.sparse_local not in SPARSE_LOCAL_MODES:
            raise ValueError(
                f"unknown sparse_local mode {self.sparse_local!r}: expected "
                f"one of {SPARSE_LOCAL_MODES}")
        if self.sparse_topk < 0:
            raise ValueError(
                f"sparse_topk must be >= 0 (0 disables top-k), got "
                f"{self.sparse_topk}")
        if self.microbatches > 1 and self.sparse:
            raise ValueError(
                "microbatches > 1 does not compose with sparse=True: the "
                "sparse plane computes one fused cohort gradient per round; "
                "set microbatches=1 or sparse=False")
