"""Port parity, the checking planes: ``common/hw.py``, the wire and combine
byte accounting of ``sparse/comm.py``, ``analysis/hlo_audit.memory_budget``
and its gate, ``analysis/jaxpr_audit``'s dense-intermediate verdicts, K2's
``heat_scatter``, and the host side of ``analysis/kernel_audit`` (ptxas
parsing, the resource and plan-coverage contracts with planted breakers,
registry coverage, the cost model against PERF.md §6's bounds) and
``kernels/_build``'s logs. The same numpy inputs go through the JAX package
and the port; byte counts and budgets are equal exactly. The contracts that
need the card (instance attributes, occupancy, grid invariance, peak device
memory) run in ``chip_smoke.py`` [59]-[63]."""
import dataclasses
import importlib
import stat
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.analysis import hlo_audit as j_hlo
from repro.analysis import jaxpr_audit as j_jaxpr
from repro.configs import FedConfig as JFedConfig
from repro.federated import make_round_step as j_make_round_step
from repro.federated import plan as jplan
from repro.models.recsys import lstm_loss as j_lstm_loss
from repro.models.recsys import make_lr_params as j_make_lr_params
from repro.models.recsys import make_lstm_params as j_make_lstm_params
from repro.sharding.logical import unbox
from repro.sparse import comm as j_comm
from repro.sparse.compress import QuantRows as JQuantRows
from repro.sparse.rowsparse import RowSparse as JRowSparse

from repro_torch.analysis import hlo_audit, jaxpr_audit, kernel_audit
from repro_torch.common.hw import HW
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.federated.plan import (CohortSharding, plan_comm_meta, resolve_plan,
                                        round_collective_budget)
from repro_torch.federated.simulation import make_round_step
from repro_torch.kernels import _build, _rows, introspect
from repro_torch.kernels.heat_scatter import heat_scatter, rowsparse_scatter_torch
from repro_torch.launch.mesh import CohortMesh
from repro_torch.models.recsys import lstm_loss
from repro_torch.sparse import comm
from repro_torch.sparse.compress import QuantRows
from repro_torch.sparse.rowsparse import RowSparse

j_heat_scatter = importlib.import_module("repro.kernels.heat_scatter")

V, E = 128, 6                      # tests/test_plan.py's LSTM
LR_V, LR_F = 96, 5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# common/hw.py: one object, the H100 SXM's numbers
# ---------------------------------------------------------------------------


def test_every_consumer_holds_the_one_hw_dict():
    chip_smoke = _chip_smoke()
    assert kernel_audit.HW is HW and introspect.HW is HW and chip_smoke.HW is HW
    assert chip_smoke.cost_model is kernel_audit.cost_model
    for name in ("HBM_BYTES_PER_S", "F32_OPS_PER_S", "BF16_OPS_PER_S", "TF32_OPS_PER_S",
                 "OPS_PER_S", "attention_work", "attention_bound", "bound"):
        assert not hasattr(chip_smoke, name), name


def test_hw_holds_the_h100_sxm():
    assert HW["hbm_bandwidth"] == 3.35e12 and HW["hbm_bytes"] == 80 * 10**9
    assert (HW["peak_flops_f32"], HW["peak_flops_tf32"], HW["peak_flops_bf16"]) == (
        67e12, 495e12, 989e12)
    assert (HW["sms"], HW["regs_per_sm"], HW["regs_per_thread"]) == (132, 65536, 255)
    assert (HW["smem_per_sm"], HW["smem_per_block"]) == (228 * 1024, 227 * 1024)
    assert (HW["threads_per_block"], HW["max_cluster"]) == (1024, 8)


# ---------------------------------------------------------------------------
# sparse/comm.py: wire bytes and the sharded combine, against the JAX package
# ---------------------------------------------------------------------------


def _rowsparse_pair(seed, lead, width, dtype):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 50, lead).astype(np.int32)
    rows = rng.normal(size=lead + width).astype(np.float32)
    jt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return (JRowSparse(jnp.asarray(ids), jnp.asarray(rows).astype(jt), 50),
            RowSparse(_t(ids), _t(rows).to(getattr(torch, dtype)), 50))


def _quant_pair(seed, lead, width):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 50, lead).astype(np.int32)
    q = rng.integers(-127, 128, lead + width).astype(np.int8)
    s = rng.random(lead).astype(np.float32)
    return (JQuantRows(jnp.asarray(ids), jnp.asarray(q), jnp.asarray(s), 50),
            QuantRows(_t(ids), _t(q), _t(s), 50))


def _leaf_cases():
    rng = np.random.default_rng(3)
    dense = rng.normal(size=(7, 5)).astype(np.float32)
    return {
        "rowsparse f32": _rowsparse_pair(0, (40,), (6,), "float32"),
        "rowsparse bf16 stacked": _rowsparse_pair(1, (3, 16), (4, 2), "bfloat16"),
        "quantrows": _quant_pair(2, (3, 16), (6,)),
        "dense": (jnp.asarray(dense), _t(dense)),
        "int scalar": (5, 5),
        "float scalar": (2.5, 2.5),
        "empty": ({}, {}),
        "nested": ({"a": [_rowsparse_pair(4, (9,), (3,), "float32")[0], jnp.ones((4,))],
                    "b": (jnp.zeros((2, 2), jnp.int32),)},
                   {"a": [_rowsparse_pair(4, (9,), (3,), "float32")[1], torch.ones(4)],
                    "b": (torch.zeros((2, 2), dtype=torch.int32),)}),
    }


@pytest.mark.parametrize("case", list(_leaf_cases()))
def test_leaf_wire_bytes_match_jax(case):
    j_leaf, t_leaf = _leaf_cases()[case]
    assert comm.leaf_wire_bytes(t_leaf) == j_comm.leaf_wire_bytes(j_leaf)


def test_tree_wire_bytes_match_jax():
    cases = _leaf_cases()
    j_tree = {k: v[0] for k, v in cases.items()}
    t_tree = {k: v[1] for k, v in cases.items()}
    assert comm.tree_wire_bytes(t_tree) == j_comm.tree_wire_bytes(j_tree)
    assert comm.tree_wire_bytes(t_tree) > 0


def _jax_params(model):
    if model == "lstm":
        return j_make_lstm_params(V, emb_dim=E, hidden=8, layers=1, rng=jax.random.PRNGKey(1))
    return j_make_lr_params(LR_V)


@pytest.mark.parametrize("model", ["lstm", "lr"])
@pytest.mark.parametrize("mode", ["psum", "union"])
@pytest.mark.parametrize("num_tables,count_ids", [(1, False), (2, True)])
def test_sharded_combine_bytes_match_jax(model, mode, num_tables, count_ids):
    jp = _jax_params(model)
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    meta, j_meta = plan_comm_meta(params, axes), jplan.plan_comm_meta(jp)
    got = comm.sharded_combine_bytes(meta, 4096, 240, 3, mode, num_tables=num_tables,
                                     count_gather_ids=count_ids)
    want = j_comm.sharded_combine_bytes(j_meta, 4096, 240, 3, mode, num_tables=num_tables,
                                        count_gather_ids=count_ids)
    assert got == want
    with pytest.raises(ValueError, match="unknown combine mode"):
        comm.sharded_combine_bytes(meta, 4096, 240, 3, "ring")


# ---------------------------------------------------------------------------
# hlo_audit: the memory budget (exactly the reference's) and the two gates
# ---------------------------------------------------------------------------


def _batch(model, seed, stacked):
    """``tests/test_torch_plan.py::_batch``: int32 ids and labels, f32 heat."""
    rng = np.random.default_rng(seed)
    if model == "lstm":
        lead = (3, 2, 2) if stacked else (6,)
        out = {"tokens": rng.integers(-1 if stacked else 0, V, lead + (8,)),
               "label": rng.integers(0, 2, lead)}
        v = V
    else:
        lead = (3, 2, 3) if stacked else (8,)
        out = {"features": rng.integers(-1, LR_V, lead + (LR_F,)),
               "label": rng.integers(0, 2, lead)}
        v = LR_V
    out = {k: x.astype(np.int32) for k, x in out.items()}
    out["heat_vocab"] = rng.integers(0, 6, v).astype(np.float32)
    return out


def _key(model):
    return "tokens" if model == "lstm" else "features"


_FED = dict(num_clients=16, clients_per_round=3, local_iters=2, lr=0.1, algorithm="fedsubavg")


@pytest.mark.parametrize("model", ["lstm", "lr"])
@pytest.mark.parametrize("mode,stacked", [("sparse", False), ("sparse_replicated", True),
                                          ("replicated", True), ("fedsgd", False)])
def test_memory_budget_matches_jax(model, mode, stacked):
    jp = _jax_params(model)
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    b = _batch(model, 7, stacked)
    j_plan = jplan.resolve_plan(mode, JFedConfig(**_FED), feature_key=_key(model))
    plan = resolve_plan(mode, FedConfig(**_FED), feature_key=_key(model))
    want = j_hlo.memory_budget(j_plan, jp, JFedConfig(**_FED),
                               {k: jnp.asarray(x) for k, x in b.items()})
    got = hlo_audit.memory_budget(plan, axes, params, FedConfig(**_FED),
                                  {k: _t(x) for k, x in b.items()})
    assert got == want


def test_memory_budget_with_sub_ids_and_clients():
    jp = _jax_params("lstm")
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    b = _batch("lstm", 8, True)
    sub = np.sort(np.random.default_rng(0).integers(0, V, (3, 24)), axis=-1).astype(np.int32)
    plan = resolve_plan("sparse_replicated", FedConfig(**_FED))
    j_plan = jplan.resolve_plan("sparse_replicated", JFedConfig(**_FED))
    args = (plan, axes, params, FedConfig(**_FED), {k: _t(x) for k, x in b.items()})
    got = hlo_audit.memory_budget(*args, sub_ids=_t(sub))
    assert got == j_hlo.memory_budget(j_plan, jp, JFedConfig(**_FED),
                                      {k: jnp.asarray(x) for k, x in b.items()},
                                      sub_ids=jnp.asarray(sub))
    more = hlo_audit.memory_budget(*args, sub_ids=_t(sub), clients=True)
    # k_shard 3 clients: the cells, head_w and head_b at the replicas'
    # factor of 4, and one local step of 2 x 8 tokens through the output
    # widths of wx, wh and head_w, each output and its gradient
    dense = sum(x.numel() for n, x in params.items() if n != "embedding")
    widths = sum(x.shape[-1] for n, x in params.items() if n != "embedding" and x.dim() == 2)
    assert more == {**got, "clients": 3 * (4.0 * 4 * dense + 2.0 * 4 * (2 * 8) * widths)}


def test_memory_contract_gate_arithmetic():
    """The reference's gate: 25% over the budget plus 1 MiB passes, a byte
    more fails, naming the largest term; a leaner plan's budget trips a
    dense-replica measurement."""
    jp = _jax_params("lstm")
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    b = {k: _t(x) for k, x in _batch("lstm", 9, True).items()}
    plan = resolve_plan("sparse_replicated", FedConfig(**_FED))
    comps = hlo_audit.memory_budget(plan, axes, params, FedConfig(**_FED), b)
    allowed = sum(comps.values()) * 1.25 + (1 << 20)
    ok = hlo_audit.memory_contract(plan, lstm_loss, axes, params, FedConfig(**_FED), b,
                                   measured=int(allowed))
    assert ok.ok and ok.budget_bytes == allowed and ok.components == comps
    fat = hlo_audit.memory_contract(plan, lstm_loss, axes, params, FedConfig(**_FED), b,
                                    measured=int(allowed) + 1, budget=comps)
    top = max(comps, key=comps.get)
    assert not fat.ok
    assert any("peak live bytes" in f and f"largest budget term '{top}'" in f
               for f in fat.failures), fat.failures
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hlo_audit.measure_step_memory(lambda s, x: None, None, b)


def test_comm_drift_arithmetic_and_planted_drift():
    """``comm_drift`` holds counted bytes to ``sharded_combine_bytes`` at
    10% + 64 B: the prediction itself passes, 10% + 65 B more fails."""
    jp = _jax_params("lstm")
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    b = {k: _t(x) for k, x in _batch("lstm", 10, True).items()}
    cfg = FedConfig(**_FED)
    plan = dataclasses.replace(resolve_plan("sparse_replicated", cfg),
                               sharding=CohortSharding(CohortMesh(0, 2, torch.device("cpu")),
                                                       combine="union"))
    budget = round_collective_budget(plan, axes, params, cfg, b)
    good = hlo_audit.comm_drift(plan, axes, params, cfg, b, measured=budget["by_op"])
    assert good.ok, good.failures
    assert good.predicted_by_op["all-gather"] > 0
    p = good.predicted_by_op["all-gather"]
    bad = hlo_audit.comm_drift(plan, axes, params, cfg, b,
                               measured={**budget["by_op"], "all-gather": 1.1 * p + 65})
    assert not bad.ok and "'all-gather'" in bad.failures[0]
    dense = dataclasses.replace(resolve_plan("replicated", cfg), sharding=plan.sharding)
    with pytest.raises(ValueError, match="one combine mode"):
        hlo_audit.comm_drift(dense, axes, params, cfg, b, measured={})


# ---------------------------------------------------------------------------
# jaxpr_audit: the reference's verdicts (tests/test_analysis_audit.py:64-100)
# ---------------------------------------------------------------------------

AV, AE = 65536, 4      # the reference test's full-vocab scale


@pytest.fixture(scope="module")
def audit_models():
    jp = j_make_lstm_params(AV, emb_dim=AE, hidden=8, layers=1, rng=jax.random.PRNGKey(1))
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    return jp, params, axes


def _audit_batch(stacked):
    r = np.random.RandomState(0)
    lead = (3, 2, 2) if stacked else (4,)
    seq = 6 if stacked else 8
    return {"tokens": r.randint(0, AV, lead + (seq,)).astype(np.int32),
            "label": r.randint(0, AV, lead).astype(np.int32),
            "heat_vocab": np.ones((AV,), np.float32)}


@pytest.mark.parametrize("mode,stacked,dense", [("sparse", False, False),
                                                ("sparse_replicated", True, False),
                                                ("fedsgd", False, True)])
def test_round_steps_dense_verdict_matches_jax(audit_models, mode, stacked, dense):
    """The sparse plans build no float (V, ...) intermediate in either
    package; the dense plan builds some in both."""
    jp, params, axes = audit_models
    cfg = dict(num_clients=50, clients_per_round=4, lr=0.1, server_lr=1.0, seed=0)
    b = _audit_batch(stacked)
    j_hits = j_jaxpr.find_dense_intermediates(
        j_make_round_step(j_lstm_loss, jp, JFedConfig(**cfg), mode=mode), jp,
        {k: jnp.asarray(x) for k, x in b.items()}, dim0=AV)
    step = make_round_step(lstm_loss, params, axes, FedConfig(**cfg), mode=mode)
    hits = jaxpr_audit.find_dense_intermediates(step, {k: v.clone() for k, v in params.items()},
                                                {k: _t(x) for k, x in b.items()}, dim0=AV)
    assert bool(hits) == bool(j_hits) == dense, ([str(h) for h in hits], j_hits)
    if not dense:
        jaxpr_audit.assert_no_dense_intermediates(
            step, {k: v.clone() for k, v in params.items()}, {k: _t(x) for k, x in b.items()},
            dim0=AV)


def test_union_at_capacity_v_is_flagged_in_both():
    """The detector reads shapes: once a sparse round's cohort reads more
    ids than the table has rows, the union's capacity is V and its rows are
    (V, D) in both packages, so both flag them; below V neither does."""
    jp = _jax_params("lstm")
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    r = np.random.RandomState(0)
    for clients, flagged in ((3, False), (6, True)):     # 96 and 192 ids of V = 128
        lead = (clients, 2, 2)
        b = {"tokens": r.randint(0, V, lead + (8,)).astype(np.int32),
             "label": r.randint(0, 2, lead).astype(np.int32),
             "heat_vocab": np.ones((V,), np.float32)}
        cfg = dict(num_clients=50, clients_per_round=clients, lr=0.1, server_lr=1.0, seed=0)
        j_hits = j_jaxpr.find_dense_intermediates(
            j_make_round_step(j_lstm_loss, jp, JFedConfig(**cfg), mode="sparse_replicated"),
            jp, {k: jnp.asarray(x) for k, x in b.items()}, dim0=V)
        step = make_round_step(lstm_loss, params, axes, FedConfig(**cfg),
                               mode="sparse_replicated")
        hits = jaxpr_audit.find_dense_intermediates(
            step, {k: v.clone() for k, v in params.items()}, {k: _t(x) for k, x in b.items()},
            dim0=V)
        assert bool(hits) == bool(j_hits) == flagged, ([str(h) for h in hits], j_hits)
        if flagged:
            assert {h.shape for h in hits} == {h.shape for h in j_hits} == {(V, E), (V, 1)}


def test_planted_densification_is_detected(audit_models):
    jp, params, _ = audit_models
    b = _audit_batch(False)

    def j_bad(params, batch):
        ids = jnp.sort(batch["tokens"].reshape(-1).astype(jnp.int32))
        dense = JRowSparse(ids, jnp.ones((ids.shape[0], AE), jnp.float32), AV).to_dense()
        return params, dense.sum()

    def bad(params, batch):
        ids = torch.sort(batch["tokens"].reshape(-1))[0]
        dense = RowSparse(ids, torch.ones((ids.shape[0], AE)), AV).to_dense()
        return params, dense.sum()

    with pytest.raises(j_jaxpr.DenseMaterializationError) as j_err:
        j_jaxpr.assert_no_dense_intermediates(j_bad, jp, {k: jnp.asarray(x)
                                                          for k, x in b.items()}, dim0=AV)
    with pytest.raises(jaxpr_audit.DenseMaterializationError) as err:
        jaxpr_audit.assert_no_dense_intermediates(bad, params, {k: _t(x) for k, x in b.items()},
                                                  dim0=AV)
    assert any(h.shape == (AV, AE) for h in j_err.value.hits)
    assert any(h.shape == (AV, AE) for h in err.value.hits)
    assert "dense (V=65536" in str(err.value)


def test_int_workspaces_and_views_are_not_hits():
    """Integer (V, 1) marks (the reference's case) and views of an input
    table are no materialisation; an in-place index_add_ into the table is
    the allowed table write, and a clone of it is a hit."""
    def workspace(tokens):
        return torch.zeros((AV, 1), dtype=torch.int32).index_add_(
            0, tokens, torch.ones((tokens.numel(), 1), dtype=torch.int32)).sum()

    def j_workspace(tokens):
        return jnp.zeros((AV, 1), jnp.int32).at[tokens].add(1).sum()

    assert jaxpr_audit.find_dense_intermediates(workspace, torch.arange(8), dim0=AV) == []
    assert j_jaxpr.find_dense_intermediates(j_workspace, jnp.arange(8), dim0=AV) == []
    table = torch.zeros((AV, AE))
    ids, rows = torch.arange(8), torch.ones((8, AE))
    views = lambda t: t.detach().view(AV, AE, 1)[:, :2].transpose(0, 0)  # noqa: E731
    assert jaxpr_audit.find_dense_intermediates(views, table, dim0=AV) == []
    write = lambda t: t.index_add_(0, ids, rows)                         # noqa: E731
    assert jaxpr_audit.find_dense_intermediates(write, table, dim0=AV) == []
    hits = jaxpr_audit.find_dense_intermediates(lambda t: t.clone().index_add_(0, ids, rows),
                                                table, dim0=AV)
    assert [h.primitive for h in hits] == ["aten.clone"]


# ---------------------------------------------------------------------------
# K2's heat_scatter: the reference's scale-1 case
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_heat_scatter_matches_jax_kernel(dtype):
    rng = np.random.default_rng(5)
    t, d, v = 512, 16, 96
    ids = rng.integers(-1, v, t).astype(np.int32)
    rows = rng.normal(size=(t, d)).astype(np.float32)
    heat = rng.integers(0, 7, v).astype(np.float32)
    t_rows = _t(rows).to(getattr(torch, dtype))
    got = heat_scatter(_t(ids), t_rows, _t(heat), 40.0, v)
    want = j_heat_scatter.heat_scatter(jnp.asarray(ids), jnp.asarray(rows).astype(dtype),
                                       jnp.asarray(heat), 40.0, v, v_blk=32, t_blk=128,
                                       interpret=True)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_array_equal(
        got.numpy(), rowsparse_scatter_torch(_t(ids), t_rows, _t(heat), 40.0, v).numpy())


# ---------------------------------------------------------------------------
# kernel_audit on the host: ptxas, the contracts, coverage, the cost model
# ---------------------------------------------------------------------------

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__65e0f50d_15_union_segsum_cu_1c81a7fc19union_segsum_kernelIfLi4EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__65e0f50d_15_union_segsum_cu_1c81a7fc19union_segsum_kernelIfLi4EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 62 registers, used 1 barriers, 64 bytes smem
ptxas info    : Compile time = 126.289 ms
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__65e0f50d_15_union_segsum_cu_1c81a7fc19union_segsum_kernelIfLi2EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__65e0f50d_15_union_segsum_cu_1c81a7fc19union_segsum_kernelIfLi2EEEvNS_4ArgsE
    8 bytes stack frame, 4 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 8 bytes cumulative stack size, 64 bytes smem
ptxas info    : Compiling entry function '_ZN55_dkv_kernelILi128EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN55_dkv_kernelILi128EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers
"""
_F4 = "_ZN48_GLOBAL__N__65e0f50d_15_union_segsum_cu_1c81a7fc19union_segsum_kernelIfLi4EEEvNS_4ArgsE"
_F2 = _F4.replace("IfLi4E", "IfLi2E")


def test_parse_ptxas_fixture():
    info = kernel_audit.parse_ptxas(PTXAS)
    assert set(info) == {_F4, _F2, "_ZN55_dkv_kernelILi128EEEv"}
    assert info[_F4] == kernel_audit.PtxasInfo(62, 0, 0, 0, smem=64)
    assert info[_F2] == kernel_audit.PtxasInfo(64, 8, 4, 36, smem=64)
    assert info["_ZN55_dkv_kernelILi128EEEv"].regs == 254


def _resources(launch, ptxas=None, min_blocks=2, **attrs):
    base = dict(regs=64, local_bytes=0, static_smem=64, max_threads=512, dyn_smem=0,
                threads=512, blocks_per_sm=2, sms=132, cluster=1, clusters=0, ptx=90,
                binary=90)
    return kernel_audit.InstanceResources(
        "union_segsum", launch, _F4, {**base, **attrs},
        ptxas if ptxas is not None else kernel_audit.parse_ptxas(PTXAS)[_F4], min_blocks)


def _k1_launch(cooperative=264):
    return introspect.Launch("union_segsum_kernel<float, 4>", 2, grid=(cooperative, 1, 1),
                             cooperative=cooperative)


def test_resource_contract_passes_and_planted_spill_fails():
    assert kernel_audit.resource_contract(_resources(_k1_launch())).ok
    spilled = kernel_audit.parse_ptxas(PTXAS)[_F2]
    rep = kernel_audit.resource_contract(_resources(_k1_launch(), ptxas=spilled))
    assert [f.split()[0] for f in rep.failures] == ["[spill]"]
    assert "4 B of stores and 36 B of loads" in rep.failures[0]


@pytest.mark.parametrize("breaker,tag", [
    (dict(cluster=16), "[cluster]"),
    (dict(cooperative=2 * 132 + 1), "[cooperative-grid]"),
    (dict(dyn_smem=227 * 1024), "[smem]"),
    (dict(blocks_per_sm=1), "[occupancy]"),
    (dict(threads=1024), "[threads]"),
    (dict(ptxas="missing"), "[ptxas-missing]"),
])
def test_planted_breakers_fail_with_their_diagnostic(breaker, tag):
    launch = _k1_launch(breaker.get("cooperative", 264))
    if "blocks_per_sm" in breaker:     # a grid that need not be resident at once
        launch = dataclasses.replace(launch, cooperative=0)
    if "cluster" in breaker:
        launch = introspect.Launch("dkv_kernel<128, Tf32x3>", 7, arg=5, grid=(10, 8, 16),
                                   cluster=breaker["cluster"], groups=5)
    attrs = {k: v for k, v in breaker.items() if k in ("dyn_smem", "blocks_per_sm", "threads")}
    res = _resources(launch, **attrs)
    if breaker.get("ptxas") == "missing":
        res = dataclasses.replace(res, ptxas=None)
    rep = kernel_audit.resource_contract(res)
    assert rep.failures and all(f.startswith(tag) for f in rep.failures), rep.failures
    if "cluster" in breaker:      # over 8, and not dividing the group of 5
        assert len(rep.failures) == 2


def test_registry_covers_every_global_and_symbol():
    assert kernel_audit.registry_coverage() == []
    short = tuple(e for e in introspect.REGISTRY if e.name != "flash_attention_bwd")
    f = kernel_audit.registry_coverage(short)
    assert any("__global__ dkv_kernel" in x for x in f)
    assert any("symbol flash_attention_bwd_instance" in x for x in f)
    assert all(x.startswith("[coverage]") for x in f)


def test_declared_min_blocks_read_from_the_sources():
    want = {"union_segsum_kernel": 2, "rowsparse_scatter_kernel": 2, "attention_kernel": 1,
            "attention_kernel_f32": 2, "dq_kernel": 2, "dkv_kernel": 2, "split_kernel": 1,
            "split_kernel_tc": 1, "merge_kernel": 1}
    assert {g: kernel_audit.declared_min_blocks(g) for g in want} == want


def test_plans_cover_their_work_at_every_audit_shape():
    n = 0
    for e in introspect.REGISTRY:
        for a in e.shapes:
            assert kernel_audit.plan_coverage(e, a.shape, introspect.launches(e, a.shape)) == [], (
                e.name, a.name)
            n += 1
    assert n == 28
    k4 = introspect.entry("flash_decode")
    shape = dict(B=2, H=4, KV=2, S=4096, hd=128, dtype="f32")
    for split in ((3, 1024), (64, 96)):            # too few slices; not whole tiles
        bad = introspect.launches(k4, dict(shape, split=split))
        assert kernel_audit.plan_coverage(k4, shape, bad)[0].startswith("[plan]")


def test_instance_indices_follow_the_sources_queries():
    """``<source>_instance``'s index conventions (csrc/*.cu), read back
    from the labels the registry gives each launch."""
    k4 = introspect.entry("flash_decode")
    split, merge = introspect.launches(k4, dict(B=4, H=40, KV=8, S=1056, hd=128, dtype="bf16"))
    assert (split.index, split.label) == (7, "split_kernel_tc<128>")
    assert (merge.index, merge.label) == (15, "merge_kernel<__nv_bfloat16, 128>")
    bwd = introspect.entry("flash_attention_bwd")
    dq, dkv = introspect.launches(bwd, bwd.shapes[0].shape)
    assert (dq.index, dkv.index, dkv.arg, dkv.cluster) == (6, 7, 5, 5)
    k1 = introspect.entry("union_segsum")
    (ln,) = introspect.launches(k1, dict(V=1 << 22, T=512000, D=18, cap=512000, dtype="bf16"))
    assert (ln.index, ln.label) == (4, "union_segsum_kernel<__nv_bfloat16, 2>")


def _chip_smoke():
    sys.path.insert(0, str(_build.CSRC.parents[3]))
    import chip_smoke
    return chip_smoke


def test_cost_model_reproduces_section6_bounds():
    """Every PERF.md §6 bound that ``chip_smoke.py`` [60] holds, to its 4th
    decimal and its bounding resource, from ``cost_model``."""
    cs = _chip_smoke()
    assert len(cs.SECTION6_BOUNDS) >= 4
    for label, kernel, shape, key, want, by in cs.SECTION6_BOUNDS:
        got, got_by, _, _ = cs.section6_bound(kernel, shape, key)
        assert (round(got, 4), got_by) == (want, by), label


def test_cost_model_prices_k1_scratch_as_the_plan():
    plan = _rows.union_plan(512000, 18, 1 << 22, 512000, 2, 264)
    c = kernel_audit.cost_model("union_segsum", t=512000, d=18, cap=512000, n_union=1,
                                num_rows=1 << 22, blocks=plan.blocks)
    assert c.extra["scratch_bytes"] == plan.scratch_bytes
    with pytest.raises(KeyError):
        kernel_audit.cost_model("matmul", b=1)


@pytest.mark.parametrize("shape,nbytes,flops,route_ms,route_by", [
    # [38]'s training shape: B 16, S 128, H 40 / KV 8, hd 128, causal (128 x
    # 129 / 2 = 8,256 pairs a (batch, head)); q and o 16 x 128 x 40 rows, k
    # and v 16 x 128 x 8, of 128 f32 each
    (dict(b=16, sq=128, h=40, kv=8, hd=128, keys=128, pairs=8256),
     4 * 2 * 16 * 128 * (128 * 40 + 128 * 8), 4 * 16 * 40 * 128 * 8256,
     100_663_296 / 3.35e12 * 1e3, "bytes"),
    # Whisper's encoder training shape: B 8, 1,500 x 1,500, H = KV = 20, hd
    # 64, non-causal (1,500^2 pairs)
    (dict(b=8, sq=1500, h=20, kv=20, hd=64, keys=1500, pairs=1500 * 1500),
     4 * 2 * 8 * 64 * (1500 * 20 + 1500 * 20), 4 * 8 * 20 * 64 * 1500 * 1500,
     3 * 9.216e10 / 495e12 * 1e3, "operations"),
])
def test_cost_model_prices_k3_f32_on_its_3xtf32_route(shape, nbytes, flops, route_ms, route_by):
    """K3 in f32 runs each product as 3 TF32 products on the tensor cores:
    its route bound is the larger of its bytes at 3.35 TB/s and 3 times its
    flops at 495 TFLOP/s (0.0300 ms by bytes, 100.7 MB, at [38]; 0.5585 ms
    by operations at Whisper's encoder), beside its bound on the f32 CUDA
    cores; bf16 has no separate route."""
    c = kernel_audit.cost_model("flash_attention", dtype="f32", **shape)
    assert (c.bytes, c.flops) == (nbytes, flops)
    assert c.extra["route_rate"] == "3xTF32" and c.extra["route_by"] == route_by
    assert c.extra["route_ms"] == pytest.approx(route_ms, rel=1e-12)
    assert round(c.extra["route_ms"], 4) == (0.0300 if route_by == "bytes" else 0.5585)
    assert c.bound_ms == pytest.approx(max(nbytes / HW["hbm_bandwidth"],
                                           flops / HW["peak_flops_f32"]) * 1e3, rel=1e-12)
    assert kernel_audit.cost_model("flash_attention", dtype="bf16", **shape).extra == {}


def test_analysis_submodules_load_lazily():
    import repro_torch.analysis as pkg
    assert set(pkg._SUBMODULES) == {"sanitize", "jaxpr_audit", "hlo_audit", "kernel_audit",
                                    "lint"}
    assert pkg.kernel_audit is kernel_audit and pkg.hlo_audit is hlo_audit
    import repro_torch.analysis.lint as lint
    assert pkg.lint is lint
    with pytest.raises(AttributeError):
        pkg.no_such_plane


def test_build_keeps_ptxas_logs_beside_cached_libraries(tmp_path, monkeypatch):
    """nvcc's output is written beside each library and read back when every
    library is already built (a stand-in nvcc here; the card runs nvcc)."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/usr/bin/env python3\nimport sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\nopen(out, 'wb').close()\n"
                    "print('ptxas info    : Used 7 registers for', sys.argv[-1].rsplit('/', 1)[-1])\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    first = _build.build()
    assert set(first.logs) == set(_build.SIGNATURES)
    assert all("Used 7 registers" in log for log in first.logs.values())
    again = _build.build()
    assert again.logs == first.logs and again.directory == first.directory
    (first.directory / "flash_decode.log").unlink()     # a library without its log is rebuilt
    third = _build.build()
    assert third.logs["flash_decode"] == first.logs["flash_decode"]
