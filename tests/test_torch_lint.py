"""The port's mesh and in-place linter (``repro_torch.analysis.lint``) held
against the reference's (``repro.analysis.lint``): every rule fires once on
its seeded fixture, the allowlist and the report match the reference's,
writers resolve across files, and ``src/repro_torch`` is clean."""
import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures_torch")
ENV = dict(os.environ, PYTHONPATH=SRC)

#: fixture file -> the one rule it seeds (each also carries safe variants
#: that must NOT fire)
_SEEDED = {
    "viol_shard_full_aggregate.py": "shard-full-aggregate",
    "viol_shard_missing_psum.py": "shard-missing-psum",
    "viol_donated_reuse.py": "donated-reuse",
    "viol_split_telemetry.py": "shard-missing-psum",
    "viol_view_apply.py": "donated-reuse",
}


@pytest.fixture(scope="module")
def port_run():
    return lint.lint_paths([PORT])


@pytest.fixture(scope="module")
def port_project():
    modules = []
    for path in lint.iter_python_files([PORT]):
        with open(path, encoding="utf-8") as f:
            modules.append(lint._Module(f.read(), path))
    return lint._Project(modules)


# ---------------------------------------------------------------------------
# seeded violations: one fixture per rule, exactly one hit each
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture,rule", sorted(_SEEDED.items()))
def test_seeded_violation_fires(fixture, rule):
    path = os.path.join(FIXTURES, fixture)
    violations, suppressions, n = lint.lint_paths([path])
    assert n == 1
    assert not suppressions
    assert [v.rule for v in violations] == [rule], (
        f"{fixture} must trip exactly its seeded rule; got "
        f"{[(v.rule, v.line) for v in violations]}")
    with open(path, encoding="utf-8") as f:
        marked = [i for i, ln in enumerate(f.read().splitlines(), 1) if "VIOLATION" in ln]
    assert marked and any(abs(violations[0].line - m) <= 2 for m in marked)


def test_fixtures_are_ast_only_for_the_reference():
    """The torch fixtures trip nothing of the reference's (they hold no jit,
    no shard_map): each is the torch form of its class."""
    violations, _, n = ref_lint.lint_paths([FIXTURES])
    assert n == len(_SEEDED) and not violations


# ---------------------------------------------------------------------------
# allowlist: the reference's syntax, map and messages
# ---------------------------------------------------------------------------

_ALLOW_SOURCES = {
    "reason_inline": "x = y.sum()  # repro-lint: ok shard-missing-psum -- per-rank knob\n",
    "comment_above_continued": textwrap.dedent("""\
        def f(x):
            # repro-lint: ok shard-missing-psum -- reason spanning
            # a second comment line
            return x.sum()
        """),
    "bare": "x = y.sum()  # repro-lint: ok shard-missing-psum\n",
    "unknown_rule": "x = y.sum()  # repro-lint: ok no-such-rule -- whatever\n",
    "wildcard": "x = y.sum()  # repro-lint: ok * -- prototype code\n",
    "reason_on_next_comment": textwrap.dedent("""\
        # repro-lint: ok donated-reuse
        # -- the caller rebinds the table two lines down
        out = apply(table, rows)
        """),
    "comment_only_block": textwrap.dedent("""\
        # repro-lint: ok shard-missing-psum,donated-reuse -- a block that
        # explains itself
        #
        # over four comment lines

        y = x.mean()
        z = 1
        """),
    "bare_comment_only": "# repro-lint: ok shard-full-aggregate\nz = 1\n",
    "unknown_and_bare": "z = 1  # repro-lint: ok shard-missing-psum, not-a-rule\n",
    "no_suppression": "z = x.sum()  # an ordinary comment\n",
}


@pytest.mark.parametrize("case", sorted(_ALLOW_SOURCES))
def test_allowlist_matches_the_reference(case):
    src = _ALLOW_SOURCES[case]
    allow, bare = lint._collect_allowlist(src, "mod.py")
    ref_allow, ref_bare = ref_lint._collect_allowlist(src, "mod.py")
    assert allow == ref_allow
    assert [(v.rule, v.line, v.col, v.message) for v in bare] == [
        (v.rule, v.line, v.col, v.message) for v in ref_bare]


def test_reference_only_rule_is_unknown_to_the_port():
    """A rule the port does not check is dead in a suppression here: the
    reference accepts it, the port reports it."""
    src = "z = 1  # repro-lint: ok traced-float -- a jit rule\n"
    _, bare = lint._collect_allowlist(src, "mod.py")
    _, ref_bare = ref_lint._collect_allowlist(src, "mod.py")
    assert not ref_bare
    assert [v.rule for v in bare] == ["bare-allowlist"]
    assert "traced-float" in bare[0].message


_VIOLATING = """
from repro_torch.launch.mesh import shard_body


@shard_body
def f(x):
    return x.sum(){allow}
"""


@pytest.mark.parametrize("allow,rules,n_supp", [
    ("  # repro-lint: ok shard-missing-psum -- per-rank by design", [], 1),
    ("  # repro-lint: ok shard-missing-psum", ["bare-allowlist"], 0),
    ("  # repro-lint: ok no-such-rule -- whatever",
     ["bare-allowlist", "shard-missing-psum"], 0),
    ("  # repro-lint: ok * -- prototype code", [], 1),
    ("", ["shard-missing-psum"], 0),
])
def test_allowlist_suppresses_as_the_reference_does(allow, rules, n_supp):
    violations, suppressions = lint.lint_source(_VIOLATING.format(allow=allow), "mod.py")
    assert sorted(v.rule for v in violations) == rules
    assert len(suppressions) == n_supp
    for s in suppressions:
        assert s.reason and s.rule == "shard-missing-psum"


def test_allowlist_comment_line_above_suppresses():
    src = textwrap.dedent("""
        from repro_torch.launch.mesh import shard_body


        @shard_body
        def f(x):
            # repro-lint: ok shard-missing-psum -- reason spanning
            # a second comment line
            return x.sum()
    """)
    violations, suppressions = lint.lint_source(src, "mod.py")
    assert not violations
    assert [s.reason for s in suppressions] == ["reason spanning"]


# ---------------------------------------------------------------------------
# the report and the rule table
# ---------------------------------------------------------------------------


def test_report_schema_matches_the_reference():
    v = lint.Violation("shard-missing-psum", "m.py", 3, 4, "msg")
    s = lint.Suppression("donated-reuse", "m.py", 5, "why")
    rv = ref_lint.Violation("shard-missing-psum", "m.py", 3, 4, "msg")
    rs = ref_lint.Suppression("donated-reuse", "m.py", 5, "why")
    assert v.as_dict() == rv.as_dict() and s.as_dict() == rs.as_dict()
    rep = lint.report_dict([v], [s], 1, ["m.py"])
    ref = ref_lint.report_dict([rv], [rs], 1, ["m.py"])
    assert list(rep) == list(ref)
    assert rep["tool"] == "repro_torch.analysis.lint" and rep["version"] == ref["version"] == 1
    assert rep["rules"] == lint.RULES and rep["ok"] is False
    assert rep["violations"] == ref["violations"] and rep["suppressions"] == ref["suppressions"]
    assert set(lint.RULES) <= set(ref_lint.RULES)
    assert set(lint.RULES) == {"shard-full-aggregate", "shard-missing-psum", "donated-reuse",
                               "bare-allowlist"}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_nonzero_on_fixtures_zero_on_clean(tmp_path, capsys):
    assert lint.main([FIXTURES]) == 1
    assert "5 violation(s)" in capsys.readouterr().out
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert lint.main([str(clean)]) == 0
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert lint.main([str(broken)]) == 2
    assert "syntax error" in capsys.readouterr().err


def test_cli_json_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert lint.main([FIXTURES, "--json", str(out), "-q"]) == 1
    assert capsys.readouterr() == ("", "")
    rep = json.loads(out.read_text())
    assert rep["tool"] == "repro_torch.analysis.lint" and rep["version"] == 1
    assert rep["ok"] is False and rep["paths"] == [FIXTURES]
    assert rep["files_scanned"] == len(_SEEDED)
    assert rep["rules"] == lint.RULES
    got = sorted((v["rule"], os.path.basename(v["path"])) for v in rep["violations"])
    assert got == sorted((r, f) for f, r in _SEEDED.items())
    for v in rep["violations"]:
        assert {"rule", "path", "line", "col", "message"} == set(v)


def test_cli_list_rules_and_default_path(capsys):
    assert lint.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in out.splitlines()] == list(lint.RULES)
    # as a module from the repo root, the default path is the port
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint"], cwd=REPO,
                         env=ENV, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n = len(list(lint.iter_python_files([PORT])))
    assert f"repro-lint: {n} file(s), clean" in res.stdout


def test_lint_runs_without_torch(tmp_path):
    """The module's imports are stdlib only, and run as a script it needs no
    torch (an import of torch would fail here)."""
    path = os.path.join(PORT, "analysis", "lint.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    heads = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            heads.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            heads.add(node.module.split(".")[0])
    assert heads - {"__future__"} <= set(sys.stdlib_module_names), heads
    assert not heads & {"repro", "repro_torch", "jax", "torch", "numpy"}
    code = ("import runpy, sys; sys.modules['torch'] = None; sys.modules['jax'] = None; "
            f"sys.argv = ['lint', {FIXTURES!r}, '--json', {str(tmp_path / 'r.json')!r}]; "
            f"runpy.run_path({path!r}, run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 1, res.stderr
    assert json.loads((tmp_path / "r.json").read_text())["files_scanned"] == len(_SEEDED)


# ---------------------------------------------------------------------------
# the gate: the port's own source
# ---------------------------------------------------------------------------


def test_port_source_is_lint_clean(port_run):
    violations, suppressions, n = port_run
    assert n > 50, "lint walked suspiciously few files"
    assert not violations, "\n".join(str(v) for v in violations)
    assert suppressions
    for s in suppressions:
        assert s.reason and s.reason.strip(), f"unexplained suppression: {s}"
        assert s.rule in lint.RULES


def test_port_suppressions_name_only_reference_rules():
    """Every suppression comment under the port names rules both linters
    know, so the reference's gate over ``src/`` stays clean."""
    found = 0
    for path in lint.iter_python_files([PORT]):
        with open(path, encoding="utf-8") as f:
            for ln in f:
                m = ref_lint._ALLOW_RE.search(ln)
                if not m:
                    continue
                found += 1
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                assert rules <= set(ref_lint.RULES) & set(lint.RULES), (path, ln)
                assert m.group(2), (path, ln)
    assert found >= 3


def test_sharded_step_bodies_are_shard_scopes():
    mod = lint._Module(open(os.path.join(PORT, "federated", "plan.py")).read(), "plan.py")
    names = {getattr(s, "name", "<lambda>") for s in lint.shard_scopes(mod.index, mod.tree)}
    assert {"sharded_step", "stacked_shard", "flat_shard", "sq_sum", "mean_leaf", "combine",
            "correct_dense"} <= names
    # the helpers a sharded step calls on every rank join by name
    assert {"assemble_tel", "cohort_drop_tel", "run_local", "apply_sparse"} <= names


@pytest.mark.parametrize("rel", [
    "sparse/aggregate.py", "sharding/parallel.py", "models/layers.py",
    "models/transformer.py", "models/ssm.py", "models/xlstm.py", "models/zamba.py",
    "models/whisper.py"])
def test_combine_helpers_and_model_code_are_not_shard_scopes(rel):
    """The union combine all-gathers then aggregates once, and the models'
    per-rank reductions are right by design: neither is a shard body."""
    path = os.path.join(PORT, rel)
    mod = lint._Module(open(path).read(), path)
    assert lint.shard_scopes(mod.index, mod.tree) == []


def test_planted_missing_suppressions_are_caught():
    """Without their explanations the port's per-rank reductions are
    violations: the gate holds them, not a blind spot."""
    path = os.path.join(PORT, "federated", "plan.py")
    src = open(path).read()
    stripped = "\n".join(ln for ln in src.splitlines() if "repro-lint:" not in ln)
    violations, suppressions = lint.lint_source(stripped, path)
    assert not suppressions
    assert [v.rule for v in violations] == ["shard-missing-psum"] * 4
    names = [v.message.split("shard body ")[1].split("(")[0] for v in violations]
    assert names == ["cohort_drop_tel", "cohort_drop_tel", "assemble_tel", "sq_sum"]


# ---------------------------------------------------------------------------
# writers across files
# ---------------------------------------------------------------------------


def test_writers_resolve_across_the_port(port_project):
    writes = {(port_project.module_of[node].name, node.name): w
              for node, w in port_project.writes.items() if w}
    assert writes[("repro_torch.sparse.aggregate", "apply_rowsparse")] == {"table"}
    # through the loop over params.items(), then imported by the engine
    assert writes[("repro_torch.federated.plan", "_apply_plain")] == {"params"}
    assert writes[("repro_torch.federated.async_engine", "fire_buffer")] == {"st"}
    assert writes[("repro_torch.federated.plan", "apply_sparse")] == {"state"}
    assert writes[("repro_torch.models.layers", "cache_write")] == {"k_layer", "v_layer"}


def _copy_port(tmp_path, rels):
    root = tmp_path / "src"
    for rel in rels:
        dst = root / "repro_torch" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(PORT, rel), dst)
    for d in [p for p in root.rglob("*") if p.is_dir()]:
        (d / "__init__.py").touch()
    return root


def test_planted_read_after_the_stateless_apply_is_caught(tmp_path):
    """``plan.step`` reads the pre-round parameters before the stateless
    apply writes the tables in place; a read planted after it is caught
    through apply_sparse -> _apply_plain -> apply_rowsparse, two files."""
    root = _copy_port(tmp_path, ["federated/plan.py", "sparse/aggregate.py"])
    plan = root / "repro_torch" / "federated" / "plan.py"
    src = plan.read_text()
    anchor = "            new_state = apply_sparse(state, agg)\n"
    assert src.count(anchor) == 1
    assert lint.lint_paths([str(root)])[0] == []
    plan.write_text(src.replace(anchor, anchor + "            tables = state.params\n"))
    violations, _, _ = lint.lint_paths([str(root)])
    assert [(v.rule, v.message.split("'")[1]) for v in violations] == [
        ("donated-reuse", "state")]
    # the writer lives in the other file: plan.py alone cannot see it
    assert lint.lint_paths([str(plan)])[0] == []


def test_writer_resolution_through_relative_and_module_imports(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("from pkg.ops import apply  # re-export\n")
    (pkg / "ops.py").write_text(textwrap.dedent("""\
        def apply(table, rows, out=None):
            table.view(-1).add_(rows.view(-1))
            return table

        def fill(dst, src):
            import torch
            torch.add(src, 0, out=dst)
    """))
    (pkg / "use.py").write_text(textwrap.dedent("""\
        from . import ops
        from .ops import fill
        from pkg import apply

        def a(t, r):
            n = apply(t, r)
            return n + t                       # read after write

        def b(t, r):
            parts = t.chunk(2)
            ops.apply(parts[0], r)
            return parts                       # a view of t, written

        def c(t, r):
            fill(t[0], r)
            return t                           # written through a slice

        def d(t, r):
            t = ops.apply(t, r)
            return t

        def e(t, r, fresh):
            if fresh:
                t2 = apply(t, r)
                return t2
            return t                           # the write's branch returned
    """))
    violations, _, _ = lint.lint_paths([str(pkg)])
    got = sorted((v.line, v.message.split("'")[1]) for v in violations)
    assert got == [(7, "t"), (12, "parts"), (16, "t")]


def test_lambda_and_partial_passed_to_the_marker_are_roots():
    src = textwrap.dedent("""
        from functools import partial
        from repro_torch.launch.mesh import shard_body

        def body(x, axis):
            return x.mean()

        run = shard_body(lambda x: x.sum())
        run2 = shard_body(partial(body, axis=0))
    """)
    violations, _ = lint.lint_source(src, "mod.py")
    assert sorted((v.rule, v.line) for v in violations) == [
        ("shard-missing-psum", 6), ("shard-missing-psum", 8)]


def test_aliases_follow_views_of_views_and_skip_metadata():
    src = textwrap.dedent("""\
        def apply(table, rows):
            table.add_(rows)
            return table

        def view_of_view(t, r):
            part = t[0]
            part = part.narrow(0, 1, 2)
            apply(part, r)
            return t                           # written through part

        def metadata(t, r):
            n, dt = t.shape, t.dtype
            size = t.shape
            t = apply(t, r)
            return t, n, dt, size

        def dict_leaves(params, r):
            for name, p in params.items():
                apply(p, r)
            return params                      # its leaves were written

        def comprehension(params, r):
            new = {k: apply(v, r) for k, v in params.items()}
            return new, params                 # the same, in a comprehension
    """)
    violations, _ = lint.lint_source(src, "mod.py")
    assert sorted((v.line, v.message.split("'")[1]) for v in violations) == [
        (9, "t"), (20, "params"), (24, "params")]
