"""repro_torch.analysis: the checking planes of the port.

``repro_torch.analysis.sanitize``
    The RowSparse contract checks behind ``RoundPlan(debug_checks=True)``.

``repro_torch.analysis.jaxpr_audit``
    Dense ``(V, ...)`` intermediates of one call, recorded under a
    ``TorchDispatchMode``: a RowSparse plan must build none.

``repro_torch.analysis.hlo_audit``
    A round step's peak device memory against the analytic budget, and a
    sharded step's counted combine bytes against the comm plane's
    prediction: ``python -m repro_torch.analysis.hlo_audit --json report.json``.

``repro_torch.analysis.kernel_audit``
    The Hopper kernels' launch resources, cross-block state and cost:
    ``python -m repro_torch.analysis.kernel_audit --json kernel-audit.json``.

Submodules are imported lazily, as the reference's are
(``repro/analysis/__init__.py``); the reference's ``lint`` (JAX's jit
rules) has no counterpart.
"""
from __future__ import annotations

_SUBMODULES = ("jaxpr_audit", "sanitize", "hlo_audit", "kernel_audit")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
