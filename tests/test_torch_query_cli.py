"""The port's query surfaces on the CPU: ``python -m nemo_tpu_torch.cli
query`` against the JAX package's CLI, and ``POST /query`` of the report
server (batch and watch).

* ``query``: stdout and the exit code equal the JAX CLI's, cold and warm,
  under ``--explain``, and on a malformed query or an unknown name (exit 2,
  the same error line);
* ``--serve PORT`` answers ``POST /query`` after the report, and ``--serve
  0`` (the default) is off, as in the JAX CLI;
* the report server, on a ThreadingHTTPServer bound to port 0: ``POST
  /query`` answers the result document with status 200, ``{"error": ...}``
  with 400 on bad text or a missing report name, 404 elsewhere; a GET serves
  the report's files; the watch resolver answers over a store-warm corpus
  and re-ingests only a changed sweep; ``--watch --serve`` answers a query
  while it watches.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from nemo_tpu import cli as jax_cli
from nemo_tpu.models.case_studies import write_case_study
from nemo_tpu.models.synth import SynthSpec, grow_corpus_dir, write_corpus
from nemo_tpu_torch import cli
from nemo_tpu_torch.analysis.pipeline import run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.query.engine import execute_query, ingest_corpus, oracle_query
from nemo_tpu_torch.query.lang import parse_query

BENCH_QUERY = (
    "from pre match goal[holds=true] -> @rule match goal[holds=false] -*-> @rule[type=async] "
    "match @goal -> rule -> goal count by table"
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory) -> str:
    return write_case_study("ZK-1270-racing-sent-flag", n_runs=24, seed=11,
                            out_dir=str(tmp_path_factory.mktemp("query_cli")))


def _strip(doc: dict) -> str:
    return json.dumps({k: v for k, v in doc.items() if k != "stats"}, sort_keys=True)


# ---------------------------------------------------------------------------
# the query subcommand
# ---------------------------------------------------------------------------


CLI_CASES = {
    # name: (argument lists after the query text, with {cc}/{rc} roots), runs
    "cold_then_warm": ([BENCH_QUERY, "-faultInjOut", "{d}", "--corpus-cache", "{cc}", "--result-cache", "{rc}"], 2),
    "post_runs": (["from post where run.failed match rule -*-> @goal[holds=false] runs", "-faultInjOut", "{d}",
                   "--corpus-cache", "off", "--result-cache", "off"], 1),
    "explain": ([BENCH_QUERY, "--explain"], 1),
    "bad_text": (["match wat", "-faultInjOut", "{d}"], 1),
    "unknown_name": (["from pre match goal[table=nope] tables", "-faultInjOut", "{d}", "--corpus-cache", "off",
                      "--result-cache", "off"], 1),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_query_cli_matches_jax(corpus, tmp_path, monkeypatch, capsys, case):
    # The JAX CLI sets these for its own process; monkeypatch restores them.
    for name, value in (("NEMO_CORPUS_CACHE", "off"), ("NEMO_RESULT_CACHE", "off"), ("NEMO_JAX_CACHE", "off")):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("NEMO_INJECTOR", raising=False)
    template, repeats = CLI_CASES[case]
    outs = {}
    for pkg, main, extra in (("jax", jax_cli.main, ["--platform", "cpu"]), ("port", cli.main, ["--device", "cpu"])):
        argv = ["query"] + [a.format(d=corpus, cc=str(tmp_path / pkg / "cc"), rc=str(tmp_path / pkg / "rc"))
                            for a in template] + extra
        runs = []
        for _ in range(repeats):
            rc = main(argv)
            captured = capsys.readouterr()
            errors = [ln for ln in captured.err.splitlines() if ln.startswith("query error:")]
            runs.append((rc, captured.out, errors))
        outs[pkg] = runs
    assert outs["port"] == outs["jax"]
    rc, out, errors = outs["port"][-1]
    if case in ("bad_text", "unknown_name"):
        assert rc == 2 and out == "" and len(errors) == 1
    else:
        assert rc == 0 and out.strip()
    if case == "cold_then_warm":
        assert [json.loads(o)["stats"] for _, o, _ in outs["port"]] == [
            {"cache": "miss", "segments_mapped": 1}, {"cache": "hit", "segments_mapped": 0}]


def test_query_cli_needs_a_directory(capsys):
    with pytest.raises(SystemExit) as ex:
        cli.main(["query", "match goal", "--device", "cpu"])
    assert ex.value.code == 2
    assert "-faultInjOut is required" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the report server
# ---------------------------------------------------------------------------


def _free_port() -> int:
    """A port that was free a moment ago, for the CLI's ``--serve PORT``."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _post(port: int, body, path: str = "/query") -> tuple[int, dict]:
    data = body if isinstance(body, bytes) else json.dumps(body).encode("utf-8")
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as ex:
        payload = ex.read()
        return ex.code, json.loads(payload) if payload.startswith(b"{") else {}


class _Server:
    def __init__(self, handler) -> None:
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


@pytest.fixture(scope="module")
def reports(corpus, tmp_path_factory):
    """Two debugging reports on the cpu: the family and a synthetic corpus."""
    root = str(tmp_path_factory.mktemp("query_reports"))
    other = write_corpus(SynthSpec(n_runs=8, seed=2, eot=6), str(tmp_path_factory.mktemp("query_synth")))
    return [run_debug(d, root, TorchBackend(device="cpu"), figures="none", corpus_cache="off", result_cache="off")
            for d in (corpus, other)]


def test_post_query_on_the_batch_report(reports):
    res = reports[0]
    handler = cli.query_http_handler(res.report_dir, cli.batch_molly_resolver([res]), device="cpu",
                                     result_cache="off")
    want = execute_query(parse_query(BENCH_QUERY), res.molly, device="cpu", use_cache=False)
    with _Server(handler) as srv:
        status, doc = _post(srv.port, {"query": BENCH_QUERY})
        # Each answer times its own stages: the same stages, other walls.
        assert set(doc["stats"].pop("timings")) == set(want["stats"].pop("timings"))
        assert status == 200 and doc == want
        assert _strip(doc) == _strip(oracle_query(parse_query(BENCH_QUERY), res.molly))
        status, doc = _post(srv.port, {"query": "match wat"})
        assert status == 400
        assert doc == {"error": "QueryError: unknown step kind 'wat' (expected one of goal, rule, node)"}
        status, doc = _post(srv.port, {"query": "match goal[table=nope] tables"})
        assert status == 400 and doc["error"].startswith("QueryError: unknown table 'nope'")
        assert _post(srv.port, b"[1, 2]")[0] == 400
        assert _post(srv.port, {"query": "match goal"}, path="/other")[0] == 404
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/index.html", timeout=60) as resp:
            with open(os.path.join(res.report_dir, "index.html"), "rb") as fh:
                assert resp.status == 200 and resp.read() == fh.read()


def test_post_query_picks_one_of_several_reports(reports):
    root = os.path.dirname(reports[0].report_dir)
    handler = cli.query_http_handler(root, cli.batch_molly_resolver(reports), device="cpu", result_cache="off")
    with _Server(handler) as srv:
        for res in reports:
            name = os.path.basename(res.report_dir)
            status, doc = _post(srv.port, {"query": "match @goal count", "report": name})
            assert status == 200 and doc["n_runs"] == len(res.molly.runs)
        status, doc = _post(srv.port, {"query": "match @goal count"})
        assert status == 400 and "query box needs a report name" in doc["error"]


def test_cli_serve_answers_after_the_report(corpus, tmp_path, monkeypatch, capsys):
    """``--serve PORT`` after one report: the server (here made to handle one
    request and return) answers POST /query over the report's corpus.
    ``--serve 0`` is off: the report is written and nothing is served."""
    import http.server

    argv = ["-faultInjOut", corpus, "--device", "cpu", "--figures", "none", "--corpus-cache", "off",
            "--result-cache", "off"]
    assert cli.main(argv + ["--results-dir", str(tmp_path / "R0"), "--serve", "0"]) == 0
    assert "Serving" not in capsys.readouterr().out
    monkeypatch.setattr(http.server.ThreadingHTTPServer, "serve_forever", lambda self: self.handle_request())
    port = _free_port()
    rcs = []
    serving = threading.Thread(target=lambda: rcs.append(cli.main(
        argv + ["--results-dir", str(tmp_path / "R"), "--serve", str(port)])))
    serving.start()
    text, deadline = "", time.time() + 120
    while "Serving the report at" not in text and time.time() < deadline and serving.is_alive():
        time.sleep(0.05)
        text += capsys.readouterr().out
    assert f"Serving the report at http://127.0.0.1:{port}/" in text, text
    status, doc = _post(port, {"query": BENCH_QUERY})
    serving.join(60)
    assert not serving.is_alive() and rcs == [0]
    want = execute_query(parse_query(BENCH_QUERY), ingest_corpus(corpus, "off"), device="cpu", use_cache=False)
    assert status == 200 and _strip(doc) == _strip(want)
    with pytest.raises(SystemExit):
        cli.main(["-faultInjOut", corpus, "--device", "cpu", "--out", str(tmp_path / "a.json"), "--serve", "8000"])


def test_watch_resolver_answers_over_a_store_warm_corpus(tmp_path):
    full = write_corpus(SynthSpec(n_runs=12, seed=5), str(tmp_path / "full"))
    d = str(tmp_path / "sweep" / "pb_synth")
    grow_corpus_dir(full, d, 8)
    cc = str(tmp_path / "cc")
    ingest_corpus(d, cc)  # the watcher's store, warm
    resolve = cli.watch_molly_resolver(d, None, cc)
    first = resolve({})
    assert first.store_segments and resolve({}) is first  # one ingest per poll token
    handler = cli.query_http_handler(str(tmp_path), resolve, device="cpu", result_cache=str(tmp_path / "rc"))
    with _Server(handler) as srv:
        status, doc = _post(srv.port, {"query": "from post match @goal[holds=true] tables"})
        assert status == 200 and doc["n_runs"] == 8 and doc["stats"]["cache"] == "miss"
        assert _post(srv.port, {"query": "from post match @goal[holds=true] tables"})[1]["stats"]["cache"] == "hit"
        grow_corpus_dir(full, d, 12)
        status, doc = _post(srv.port, {"query": "from post match @goal[holds=true] tables"})
        timings = doc["stats"].pop("timings")
        assert status == 200 and doc["n_runs"] == 12 and doc["stats"] == {"cache": "miss", "segments_mapped": 1}
        assert set(timings) == {"query.plan", "query.prep", "query.eval_host", "query.extract"}
    assert resolve({}) is not first


def test_watch_serve_answers_while_watching(tmp_path, capsys):
    src = write_corpus(SynthSpec(n_runs=6, seed=2, name="s"), str(tmp_path / "src"))
    dst, out = str(tmp_path / "live" / "s"), str(tmp_path / "R")
    argv = ["-faultInjOut", dst, "--device", "cpu", "--results-dir", out, "--figures", "none", "--watch",
            "--watch-poll-s", "0.05", "--watch-debounce-s", "0.1", "--watch-max-updates", "2",
            "--replay", src, "--replay-generations", "2", "--replay-interval-s", "3",
            "--corpus-cache", str(tmp_path / "cc"), "--result-cache", str(tmp_path / "rc"), "--serve", str(_free_port())]
    rcs = []
    watching = threading.Thread(target=lambda: rcs.append(cli.main(argv)))
    watching.start()
    text, deadline = "", time.time() + 60
    while "watch update 1" not in text and time.time() < deadline and watching.is_alive():
        time.sleep(0.05)
        text += capsys.readouterr().out
    assert "watch update 1" in text, text
    port = int(text.split("Serving live reports at http://127.0.0.1:")[1].split("/")[0])
    status, doc = _post(port, {"query": "match @goal count"})
    watching.join(60)
    text += capsys.readouterr().out
    assert not watching.is_alive() and rcs == [0]
    assert status == 200 and doc["n_runs"] in (3, 6), doc
    assert text.count("watch update ") == 2
