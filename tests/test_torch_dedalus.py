"""The port's mini-Dedalus fault injector (nemo_tpu_torch/dedalus/) against
the JAX package's, on the CPU.

* each of the six bundled specs at its recorded EOT/EFF/crash settings:
  ``write_molly_output`` of both packages writes the same files with equal
  bytes (runs.json, every run's provenance and space-time diagram), and
  the spec files are byte copies;
* the inline programs of tests/test_dedalus.py (deduction, induction,
  async, omission, crash, stratified negation and the rejected cycle,
  count<>, arithmetic, provenance shape, colocation, a fact before time 1)
  run through both parsers and evaluators with equal results, or raise the
  same exception class with the same message;
* ``python -m nemo_tpu_torch.dedalus`` in a subprocess writes the same
  bytes as the JAX package's library;
* a generated corpus gives the same report from ``run_debug`` on the port's
  cpu TorchBackend as from the JAX package's JaxBackend.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.dedalus import eval as jax_eval
from nemo_tpu.dedalus import faults as jax_faults
from nemo_tpu.dedalus import parser as jax_parser
from nemo_tpu.dedalus import registry as jax_registry
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.dedalus import eval as port_eval
from nemo_tpu_torch.dedalus import faults as port_faults
from nemo_tpu_torch.dedalus import parser as port_parser
from nemo_tpu_torch.dedalus import registry as port_registry

REPO = Path(__file__).resolve().parent.parent
SPECS = sorted(port_registry.BUNDLED_SPECS)


def _files(root: str) -> dict[str, bytes]:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = Path(p).read_bytes()
    return out


def test_registry_and_spec_files_are_the_jax_packages():
    assert SPECS == sorted(jax_registry.BUNDLED_SPECS)
    for name in SPECS:
        assert dataclasses.asdict(port_registry.BUNDLED_SPECS[name]) == dataclasses.asdict(
            jax_registry.BUNDLED_SPECS[name])
        port_spec = Path(port_registry.bundled_spec_path(name))
        assert port_spec.is_relative_to(REPO / "nemo_tpu_torch")
        assert port_spec.read_bytes() == Path(jax_registry.bundled_spec_path(name)).read_bytes()


@pytest.mark.parametrize("name", SPECS)
def test_bundled_spec_output_equals_jax(name, tmp_path):
    port = port_faults.write_molly_output(port_parser.load_program(port_registry.bundled_spec_path(name)),
                                          port_registry.BUNDLED_SPECS[name], str(tmp_path / "port"), name)
    jax = jax_faults.write_molly_output(jax_parser.load_program(jax_registry.bundled_spec_path(name)),
                                        jax_registry.BUNDLED_SPECS[name], str(tmp_path / "jax"), name)
    mine, theirs = _files(port), _files(jax)
    assert sorted(mine) == sorted(theirs)
    assert "runs.json" in mine and "run_0_spacetime.dot" in mine
    assert {k for k in mine if mine[k] != theirs[k]} == set()


@pytest.mark.parametrize("name", SPECS)
def test_cli_subprocess_equals_jax_library(name, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "nemo_tpu_torch.dedalus", "-spec", name, "-max-runs", "256",
                          "-o", str(tmp_path / "port")], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"Molly-format output written to: {tmp_path / 'port' / name}"
    jax = jax_faults.write_molly_output(jax_parser.load_program(jax_registry.bundled_spec_path(name)),
                                        jax_registry.BUNDLED_SPECS[name], str(tmp_path / "jax"), name)
    assert _files(str(tmp_path / "port" / name)) == _files(jax)


def test_cli_flags_override_the_recorded_settings(tmp_path):
    from nemo_tpu.dedalus.__main__ import main as jax_main
    from nemo_tpu_torch.dedalus.__main__ import main as port_main

    program = jax_registry.bundled_spec_path("pb_asynchronous")
    argv = ["-program", program, "-EOT", "5", "-EFF", "3", "-crashes", "1", "-max-runs", "9"]
    assert port_main([*argv, "-o", str(tmp_path / "port")]) == 0
    assert jax_main([*argv, "-o", str(tmp_path / "jax")]) == 0
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))


# ---------------------------------------------------------------- programs

#: (program, eot, crashes, omissions): the inline programs of
#: tests/test_dedalus.py.
PROGRAMS = {
    "shapes": ("""
        edge("a", "b")@1;
        reach(X, Y) :- edge(X, Y);
        reach(X, Y)@next :- reach(X, Y);
        ping(Y, X)@async :- edge(X, Y), notin down(Y, Y), X != Y;
        cnt(X, count<Y>) :- edge(X, Y);
        tick(X, C+1)@next :- tick(X, C), C < 5;
        """, 3, None, None),
    "deduction_induction": ("""
        a("n", "x")@1;
        b(N, X) :- a(N, X);
        b(N, X)@next :- b(N, X);
        """, 3, None, None),
    "async": ("""
        src("s", "m")@1;
        dst("s", "d")@1;
        msg(D, M)@async :- src(S, M), dst(S, D);
        """, 3, None, None),
    "omission": ("""
        src("s", "m")@1;
        dst("s", "d")@1;
        msg(D, M)@async :- src(S, M), dst(S, D);
        """, 3, None, {("s", "d", 1)}),
    "crash": ("""
        st("n", "v")@1;
        st(N, V)@next :- st(N, V);
        out("n", "peer")@1;
        out(N, P)@next :- out(N, P);
        ship(P, V)@async :- st(N, V), out(N, P);
        """, 4, {"n": 3}, None),
    "stratified_negation": ("""
        base("n", "x")@1;
        holds(N, X) :- base(N, X);
        gap(N, X) :- base(N, X), notin holds(N, X);
        """, 1, None, None),
    "count": ("""
        vote("ld", "f1")@1;
        vote("ld", "f2")@1;
        tally(L, count<F>) :- vote(L, F);
        quorum(L, L) :- tally(L, N), N >= 2;
        """, 1, None, None),
    "arithmetic": ("""
        tick("n", 0)@1;
        tick(N, C+1)@next :- tick(N, C);
        fired(N, N) :- tick(N, C), C > 2;
        """, 5, None, None),
    "provenance": ("""
        src("s", "m")@1;
        dst("s", "d")@1;
        msg(D, M)@async :- src(S, M), dst(S, D);
        got(D, M) :- msg(D, M);
        """, 2, None, None),
    "colocation": ("""
        cfg("d", "s")@1;
        src("s", "m")@1;
        msg(D, M)@async :- cfg(D, S), src(S, M);
        """, 2, None, None),
    "fact_before_time_one": ('x("n", "v")@0;', 2, None, None),
}


def _run(parser, ev, program: str, eot: int, crashes, omissions):
    """The program through one package: ("ok", its result in plain data) or
    ("raised", the exception's class name and message)."""
    try:
        res = ev.Evaluator(parser.parse_program(program), eot, crashes, omissions).run()
    except Exception as ex:  # compared by class name and message
        return ("raised", type(ex).__name__, str(ex))
    derived = {t: [(rel, sorted(rows)) for rel, rows in st.by_rel.items()] for t, st in res.derived.items()}
    return ("ok", derived, [dataclasses.astuple(m) for m in res.messages], res.prov.goals, res.prov.rules,
            res.prov.edges, res.pre_rows, res.post_rows, res.status)


@pytest.mark.parametrize("case", sorted(PROGRAMS))
def test_inline_program_equals_jax(case):
    program, eot, crashes, omissions = PROGRAMS[case]
    port = _run(port_parser, port_eval, program, eot, crashes, omissions)
    jax = _run(jax_parser, jax_eval, program, eot, crashes, omissions)
    assert port == jax
    if case in ("colocation", "fact_before_time_one"):
        assert port[:2] == ("raised", "EvalError")
    else:
        assert port[0] == "ok"


def test_parse_shapes_equal_jax():
    program = PROGRAMS["shapes"][0]
    assert dataclasses.asdict(port_parser.parse_program(program)) == dataclasses.asdict(
        jax_parser.parse_program(program))


@pytest.mark.parametrize("program", ["p(X) :- q(X)", "p(X)@7 ;"], ids=["no-semicolon", "fact-variable"])
def test_parse_errors_raise_like_jax(program):
    with pytest.raises(port_parser.DedalusSyntaxError) as mine:
        port_parser.parse_program(program)
    with pytest.raises(jax_parser.DedalusSyntaxError) as theirs:
        jax_parser.parse_program(program)
    assert str(mine.value) == str(theirs.value)


def test_negation_cycle_rejected_like_jax():
    program = """
        p(X) :- q(X), notin r(X);
        r(X) :- q(X), notin p(X);
        """
    with pytest.raises(port_eval.EvalError) as mine:
        port_eval.stratify(port_parser.parse_program(program).rules)
    with pytest.raises(jax_eval.EvalError) as theirs:
        jax_eval.stratify(jax_parser.parse_program(program).rules)
    assert str(mine.value) == str(theirs.value)
    ok = PROGRAMS["stratified_negation"][0]
    strata = [[r.head.rel for r in s] for s in port_eval.stratify(port_parser.parse_program(ok).rules)]
    assert strata == [[r.head.rel for r in s] for s in jax_eval.stratify(jax_parser.parse_program(ok).rules)]


@pytest.mark.parametrize("name", ["pb_asynchronous", "ca_2083_hinted_handoff"])
def test_fault_space_equals_jax(name):
    """The enumerated runs, crash and omission sets and statuses in order,
    under a cap that truncates ca_2083's space (the warning path)."""
    spec = dataclasses.replace(port_registry.BUNDLED_SPECS[name], max_runs=40)
    jspec = dataclasses.replace(jax_registry.BUNDLED_SPECS[name], max_runs=40)
    port = port_faults.enumerate_runs(port_parser.load_program(port_registry.bundled_spec_path(name)), spec)
    jax = jax_faults.enumerate_runs(jax_parser.load_program(jax_registry.bundled_spec_path(name)), jspec)
    assert [(r.crashes, sorted(r.omissions), r.result.status) for r in port] == [
        (r.crashes, sorted(r.omissions), r.result.status) for r in jax]


def test_dedalus_corpus_report_equals_jax(tmp_path):
    """spec -> injector -> Molly directory -> the report: the port's cpu
    TorchBackend tree equals the JAX package's JaxBackend tree."""
    name = "zk_1270_racing_flag"
    corpus = port_faults.write_molly_output(port_parser.load_program(port_registry.bundled_spec_path(name)),
                                            port_registry.BUNDLED_SPECS[name], str(tmp_path / "in"), name)
    port = run_debug(corpus, str(tmp_path / "port"), TorchBackend(device="cpu"), corpus_cache="off",
                     result_cache="off")
    jax = jax_run_debug(corpus, str(tmp_path / "jax"), JaxBackend(), corpus_cache="off", result_cache="off")
    assert port.result_cache == {"state": "off"}
    mine, theirs = report_tree_bytes(port.report_dir), jax_tree(jax.report_dir)
    assert "debugging.json" in mine and "repairs.json" in mine
    assert mine == theirs
