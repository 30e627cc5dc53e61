"""The port CLI's mesh flags and its sidecar backend, against the library and
the JAX CLI, on the CPU.

Each report through ``python -m nemo_tpu_torch.cli`` with one flag equals
the library's report with the matching TorchBackend argument and the JAX
CLI's report under the matching env var:

* ``--shard on`` (a width-1 mesh, closed after) and ``NEMO_SHARD=1``;
* ``--giant-impl device`` (giant_v 64 on a deep corpus) and
  ``NEMO_GIANT_IMPL=device``;
* ``--max-batch 3`` and ``NEMO_MAX_BATCH=3``;
* ``--graph-backend service -graphDBConn HOST:PORT`` (the port's sidecar)
  and the JAX CLI's ``--graph-backend service`` on the JAX sidecar;
* ``--fault-inj-out`` spells ``-faultInjOut`` in the report and the query
  parsers;
* ``--graph-backend python`` and ``--graph-backend neo4j`` (``-graphDBConn``
  at tests/fake_neo4j.py's server) and the JAX CLI's under the same flags,
  with ``-graphDBConn`` resolved per backend when it is not given;

and bad values exit 2, as does a device knob (``--analysis-impl``,
``--shard``, ``--giant-impl``, ``--max-batch``) or ``--out`` given with a host
backend.
"""

import functools
import hashlib

import pytest

grpc = pytest.importorskip("grpc")

from fake_neo4j import FakeNeo4jServer  # noqa: E402
from nemo_tpu import cli as jax_cli  # noqa: E402
from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree  # noqa: E402
from nemo_tpu_torch import cli  # noqa: E402
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug  # noqa: E402
from nemo_tpu_torch.backend.torch_backend import TorchBackend  # noqa: E402
from nemo_tpu_torch.models.synth import SynthSpec, write_corpus  # noqa: E402
from nemo_tpu_torch.parallel import mesh  # noqa: E402
from nemo_tpu_torch.service.server import make_server  # noqa: E402


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # The JAX CLI writes these for its process; monkeypatch restores them.
    for name, value in (("NEMO_CORPUS_CACHE", "off"), ("NEMO_RESULT_CACHE", "off"), ("NEMO_JAX_CACHE", "off")):
        monkeypatch.setenv(name, value)
    for name in ("NEMO_SHARD", "NEMO_GIANT_IMPL", "NEMO_GIANT_V", "NEMO_MAX_BATCH", "NEMO_INJECTOR"):
        monkeypatch.delenv(name, raising=False)
    yield
    mesh.close_local_group()


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_flags"))
    return {
        "synth": write_corpus(SynthSpec(n_runs=8, seed=2, eot=6), root),
        "deep": write_corpus(SynthSpec(n_runs=3, seed=5, eot=60, name="deep"), root),
    }


@pytest.fixture(scope="module")
def port_sidecar():
    server, port = make_server(port=0, device="cpu")
    server.start()
    yield f"127.0.0.1:{port}"
    server.stop(grace=None)


def _digests(tree: dict) -> dict:
    return {k: hashlib.sha256(v).hexdigest() for k, v in tree.items()}


def _port_cli(corpus: str, out: str, *flags) -> dict:
    assert cli.main(["-faultInjOut", corpus, "--device", "cpu", "--results-dir", out, *flags]) == 0
    return _digests(report_tree_bytes(f"{out}/{corpus.rstrip('/').rsplit('/', 1)[-1]}"))


def _jax_cli(corpus: str, out: str, monkeypatch, env: dict, *flags) -> dict:
    with monkeypatch.context() as m:
        for k, v in env.items():
            m.setenv(k, v)
        argv = ["-faultInjOut", corpus, "--results-dir", out, *flags]
        if "--graph-backend" not in flags:
            argv += ["--graph-backend", "jax", "--platform", "cpu"]
        assert jax_cli.main(argv) == 0
    return _digests(jax_tree(f"{out}/{corpus.rstrip('/').rsplit('/', 1)[-1]}"))


def _library(corpus: str, out: str, **kw) -> dict:
    res = run_debug(corpus, out, TorchBackend(device="cpu", **kw), figures="all")
    return _digests(report_tree_bytes(res.report_dir))


@pytest.mark.parametrize("flags, kw, env, corpus", [
    (("--shard", "on"), {"shard": "on"}, {"NEMO_SHARD": "1"}, "synth"),
    (("--max-batch", "3"), {"max_batch": 3}, {"NEMO_MAX_BATCH": "3"}, "synth"),
    (("--giant-impl", "device"), {"giant_impl": "device"}, {"NEMO_GIANT_IMPL": "device"}, "deep"),
], ids=["shard", "max-batch", "giant-impl"])
def test_cli_flag_report_equals_library_and_jax_cli(corpora, tmp_path, monkeypatch, flags, kw, env, corpus):
    extra_kw, extra_env = {}, {}
    if corpus == "deep":
        # The CLI has no giant_v flag: the deep corpus's runs leave the
        # buckets at 64 nodes, as tests/test_torch_mesh.py sets it.
        monkeypatch.setattr(cli, "TorchBackend", functools.partial(TorchBackend, giant_v=64))
        extra_kw, extra_env = {"giant_v": 64}, {"NEMO_GIANT_V": "64"}
    port = _port_cli(corpora[corpus], str(tmp_path / "port"), *flags)
    mesh.close_local_group()
    lib = _library(corpora[corpus], str(tmp_path / "lib"), **kw, **extra_kw)
    mesh.close_local_group()
    jax = _jax_cli(corpora[corpus], str(tmp_path / "jax"), monkeypatch, {**env, **extra_env})
    assert port == lib == jax


def test_cli_graph_backend_service_equals_library_and_jax_cli(corpora, tmp_path, monkeypatch, port_sidecar, sidecar,
                                                              capsys):
    port = _port_cli(corpora["synth"], str(tmp_path / "port"), "--graph-backend", "service", "-graphDBConn",
                     port_sidecar)
    assert f"on the sidecar at {port_sidecar}" in capsys.readouterr().out
    port2 = _port_cli(corpora["synth"], str(tmp_path / "port2"), "--graph-backend", "service", "--graph-db-conn",
                      port_sidecar)
    lib = _library(corpora["synth"], str(tmp_path / "lib"))
    jax = _jax_cli(corpora["synth"], str(tmp_path / "jax"), monkeypatch, {}, "--graph-backend", "service",
                   "-graphDBConn", sidecar)
    assert port == port2 == lib == jax


def test_fault_inj_out_spelling_in_report_and_query(corpora, tmp_path, capsys):
    a = _port_cli(corpora["synth"], str(tmp_path / "a"))
    assert cli.main(["--fault-inj-out", corpora["synth"], "--device", "cpu", "--results-dir", str(tmp_path / "b")]) == 0
    assert a == _digests(report_tree_bytes(str(tmp_path / "b" / "pb_synth")))
    capsys.readouterr()
    q = "match goal -> @rule tables"
    outs = []
    for spelling in ("-faultInjOut", "--fault-inj-out"):
        assert cli.main(["query", q, spelling, corpora["synth"], "--device", "cpu", "--corpus-cache", "off",
                         "--result-cache", "off"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].strip()


@pytest.mark.parametrize("flags", [
    ("--shard", "maybe"), ("--giant-impl", "gpu"), ("--max-batch", "0"), ("--max-batch", "x"),
    ("--graph-backend", "jax"), ("--graph-backend", "service", "--shard", "on"),
], ids=["shard", "giant-impl", "max-batch-0", "max-batch-x", "graph-backend", "service-shard"])
def test_bad_values_exit_2(corpora, tmp_path, flags):
    with pytest.raises(SystemExit) as ei:
        cli.main(["-faultInjOut", corpora["synth"], "--device", "cpu", "--results-dir", str(tmp_path), *flags])
    assert ei.value.code == 2


@pytest.mark.parametrize("backend", ["python", "neo4j"])
def test_cli_host_backend_equals_jax_cli(corpora, tmp_path, monkeypatch, capsys, backend):
    if backend == "neo4j":
        with FakeNeo4jServer() as srv:
            port = _port_cli(corpora["synth"], str(tmp_path / "port"), "--graph-backend", "neo4j", "-graphDBConn",
                             srv.uri)
            assert f"8 runs on the Neo4j server at {srv.uri} ->" in capsys.readouterr().out
        with FakeNeo4jServer() as srv:
            jax = _jax_cli(corpora["synth"], str(tmp_path / "jax"), monkeypatch, {}, "--graph-backend", "neo4j",
                           "-graphDBConn", srv.uri)
        assert "repairs.json" not in port
    else:
        port = _port_cli(corpora["synth"], str(tmp_path / "port"), "--graph-backend", "python")
        assert "8 runs on the host ->" in capsys.readouterr().out
        jax = _jax_cli(corpora["synth"], str(tmp_path / "jax"), monkeypatch, {}, "--graph-backend", "python")
        assert "repairs.json" in port
    assert port == jax and "debugging.json" in port


@pytest.mark.parametrize("backend, want", [("neo4j", "bolt://127.0.0.1:7687"), ("service", "127.0.0.1:50051"),
                                           ("python", ""), ("torch", "")])
def test_graph_db_conn_default_per_backend(corpora, tmp_path, monkeypatch, backend, want):
    from nemo_tpu_torch.backend import service_backend

    seen = {}
    monkeypatch.setattr(service_backend, "ServiceBackend", lambda target, **kw: seen.setdefault("target", target))

    def fake_run_debug(d, root, backend_obj, conn, **kw):
        seen["conn"] = conn
        raise SystemExit(0)

    monkeypatch.setattr(cli, "run_debug", fake_run_debug)
    with pytest.raises(SystemExit):
        cli.main(["-faultInjOut", corpora["synth"], "--device", "cpu", "--results-dir", str(tmp_path),
                  "--graph-backend", backend])
    assert seen["conn"] == want
    if backend == "service":
        assert seen["target"] == want
    with pytest.raises(SystemExit):
        cli.main(["-faultInjOut", corpora["synth"], "--device", "cpu", "--results-dir", str(tmp_path),
                  "--graph-backend", backend, "-graphDBConn", "bolt://db:1"])
    assert seen["conn"] == "bolt://db:1"


@pytest.mark.parametrize("backend", ["python", "neo4j"])
@pytest.mark.parametrize("flags", [("--analysis-impl", "dense"), ("--analysis-impl", "auto"), ("--shard", "auto"),
                                   ("--giant-impl", "device"), ("--max-batch", "3"), ("--out", "a.json")],
                         ids=["analysis-impl", "analysis-impl-auto", "shard", "giant-impl", "max-batch", "out"])
def test_device_knob_with_host_backend_exits_2(corpora, tmp_path, capsys, backend, flags):
    with pytest.raises(SystemExit) as ei:
        cli.main(["-faultInjOut", corpora["synth"], "--device", "cpu", "--results-dir", str(tmp_path),
                  "--graph-backend", backend, *flags])
    assert ei.value.code == 2
    assert f"--graph-backend {backend}" in capsys.readouterr().err
    assert not (tmp_path / "pb_synth").exists() and not (tmp_path / "a.json").exists()
