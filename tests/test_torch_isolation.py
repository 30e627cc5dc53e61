"""The port stands alone and never falls back.

* importing nemo_tpu_torch and every submodule loads neither JAX nor any
  module of the JAX package (checked in a fresh interpreter);
* no file of the port, nor chip_smoke.py, imports either;
* asking for the card where there is none raises instead of running on the
  CPU: the backend, the analysis document and the report;
* a CPU tensor into a kernel wrapper (closure, edge_wave) takes the plain
  version and never loads the kernel library; a tensor on any other
  non-CUDA device raises;
* the new ingest and cache flags leave the device at cuda, ``ingest="auto"``
  on TorchBackend resolves to the native engine, and the port's engine is
  its own copy, built into the port's build directory;
* only the sidecar's transport imports grpc: no port module imports grpc
  or protobuf at its top, and the sidecar's ``--device cuda`` raises
  without a card;
* the fleet (serve/router.py, serve/autoscale.py, obs/federation.py, the
  shared tier and the lease) imports and routes in process with grpc
  unimportable; a ``host:port`` target then raises, and importing
  ``nemo_tpu_torch.serve`` loads no router;
* the host backends, ``--graph-backend python`` and ``--graph-backend
  neo4j``, build no kernel library and run where there is no card, while
  ``--graph-backend torch`` still defaults to cuda.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nemo_tpu_torch import device as port_device
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.kernels import closure as k1
from nemo_tpu_torch.kernels import edge_wave as k2

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "nemo_tpu_torch"

_IMPORT_ALL = """
import pkgutil, sys, importlib
import nemo_tpu_torch
for m in pkgutil.walk_packages(nemo_tpu_torch.__path__, "nemo_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "nemo_tpu" or k.startswith("nemo_tpu."))
print(len([k for k in sys.modules if k.startswith("nemo_tpu_torch")]), bad)
"""


def test_import_loads_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20, out.stdout
    assert bad.strip() == "[]", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|nemo_tpu)\b(?!_torch)|from\s+(jax|jaxlib|nemo_tpu)\b(?!_torch))",
    re.MULTILINE,
)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_imports_nothing_of_jax(path):
    text = (REPO / path).read_text()
    assert not _FORBIDDEN.search(text), _FORBIDDEN.search(text).group(0)


def test_cuda_request_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_device.resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        port_device.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchBackend()
    assert port_device.resolve_device("cpu").type == "cpu"


def test_cli_defaults_to_cuda(monkeypatch, corpus_dir, tmp_path):
    from nemo_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["-faultInjOut", corpus_dir, "--out", str(tmp_path / "a.json")])
    assert not (tmp_path / "a.json").exists()


@pytest.mark.parametrize("flags", [[], ["--graph-backend", "torch"]], ids=["default", "torch"])
def test_cli_torch_backend_defaults_to_cuda(monkeypatch, corpus_dir, tmp_path, flags):
    """With -graphDBConn's default resolved per backend (None in argparse),
    the torch backend still asks for the card, and raises without one."""
    from nemo_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["-faultInjOut", corpus_dir, "--results-dir", str(tmp_path / "R"), *flags])
    assert not (tmp_path / "R").exists()


@pytest.mark.parametrize("backend", ["python", "neo4j"])
def test_host_backends_build_no_kernel_and_need_no_card(monkeypatch, corpus_dir, tmp_path, capsys, backend):
    from fake_neo4j import FakeNeo4jServer
    from nemo_tpu_torch import cli
    from nemo_tpu_torch.kernels import build as kbuild

    def no_kernel(*a, **k):
        raise AssertionError("a host backend must not build or load a kernel library")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, name in ((kbuild, "build"), (kbuild, "load"), (k1, "_lib"), (k2, "_lib")):
        monkeypatch.setattr(mod, name, no_kernel)
    argv = ["-faultInjOut", corpus_dir, "--results-dir", str(tmp_path / "R"), "--graph-backend", backend]
    with FakeNeo4jServer() as srv:
        assert cli.main(argv + (["-graphDBConn", srv.uri] if backend == "neo4j" else [])) == 0
    assert "on cuda" not in capsys.readouterr().out
    assert (tmp_path / "R" / os.path.basename(corpus_dir) / "debugging.json").exists()


def test_report_defaults_to_cuda(monkeypatch, corpus_dir, tmp_path):
    from nemo_tpu_torch import cli
    from nemo_tpu_torch.analysis.pipeline import run_debug

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["-faultInjOut", corpus_dir, "--results-dir", str(tmp_path / "R")])
    with pytest.raises(RuntimeError, match="cuda"):
        run_debug(corpus_dir, str(tmp_path / "R"))
    assert not (tmp_path / "R").exists()


def test_cpu_tensor_takes_plain_version(monkeypatch):
    def no_kernel():
        raise AssertionError("the CUDA library must not be loaded for a CPU tensor")

    monkeypatch.setattr(k1, "_lib", no_kernel)
    monkeypatch.setattr(k1.closure, "launches", 0)
    adj = torch.rand(4, 16, 16, generator=torch.Generator().manual_seed(0)) < 0.1
    got = k1.closure(adj, max_len=5)
    assert k1.closure.launches == 0
    assert torch.equal(got, k1.closure_plain(adj, max_len=5))


def test_other_devices_raise():
    with pytest.raises(ValueError, match="unsupported device"):
        k1.closure(torch.zeros(2, 8, 8, dtype=torch.bool, device="meta"))


def test_edge_wave_cpu_tensor_takes_plain_version(monkeypatch):
    def no_kernel():
        raise AssertionError("the CUDA library must not be loaded for a CPU tensor")

    monkeypatch.setattr(k2, "_lib", no_kernel)
    monkeypatch.setattr(k2.edge_wave, "launches", 0)
    g = torch.Generator().manual_seed(0)
    state = torch.rand(4, 16, generator=g) < 0.2
    src = torch.randint(0, 16, (4, 24), generator=g, dtype=torch.int32)
    dst = torch.randint(0, 16, (4, 24), generator=g, dtype=torch.int32)
    mask = torch.rand(4, 24, generator=g) < 0.8
    for n_steps in (2, None):
        got = k2.edge_wave(state, src, dst, mask, n_steps)
        assert torch.equal(got, k2.edge_wave_plain(state, src, dst, mask, n_steps))
    assert k2.edge_wave.launches == 0


def test_edge_wave_other_devices_raise():
    z = torch.zeros(2, 8, dtype=torch.bool, device="meta")
    e = torch.zeros(2, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k2.edge_wave(z, e, e, torch.zeros(2, 4, dtype=torch.bool, device="meta"), None)


def test_cache_flags_keep_cuda_default(monkeypatch, corpus_dir, tmp_path):
    from nemo_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flags in (["--ingest", "native"], ["--corpus-cache", "off", "--result-cache", str(tmp_path / "rc")],
                  ["--ingest", "python", "--corpus-cache", str(tmp_path / "cc")]):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["-faultInjOut", corpus_dir, "--results-dir", str(tmp_path / "R"), *flags])
    assert not (tmp_path / "R").exists()
    out = tmp_path / "cpu"
    assert cli.main(["-faultInjOut", corpus_dir, "--device", "cpu", "--results-dir", str(out), "--figures", "none",
                     "--ingest", "native", "--corpus-cache", "off", "--result-cache", "off"]) == 0
    assert (out / os.path.basename(corpus_dir) / "debugging.json").exists()


@pytest.mark.parametrize(
    "mode, packed", [("auto", True), ("native", True), ("python", False)]
)
def test_ingest_mode_on_torch_backend(mode, packed):
    from nemo_tpu_torch.analysis.pipeline import _resolve_ingest_mode

    assert _resolve_ingest_mode(TorchBackend(device="cpu"), mode) is packed


def test_engine_is_the_ports_own_copy():
    from nemo_tpu_torch.ingest.native import NATIVE

    lib = NATIVE.load()
    assert NATIVE.src == PORT / "csrc" / "host" / "nemo_native.cpp"
    assert Path(lib._name).parent == PORT / "build"
    assert lib.nemo_abi_version() == 7


_TOP_LEVEL_GRPC = re.compile(r"^(import\s+(grpc|google\.protobuf)\b|from\s+(grpc|google\.protobuf)\b)", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")))
def test_no_port_module_imports_grpc_at_its_top(path):
    """grpc is imported inside make_server and the client's channel only,
    so that the card's machine, which has no grpc, imports every module."""
    text = (REPO / path).read_text()
    assert not _TOP_LEVEL_GRPC.search(text), _TOP_LEVEL_GRPC.search(text).group(0)


def test_sidecar_cuda_request_raises_without_a_card(monkeypatch):
    from nemo_tpu_torch.service.server import Loopback

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Loopback("cuda")


_FLEET_WITHOUT_GRPC = """
import sys
sys.modules["grpc"] = None  # import grpc raises ImportError
import nemo_tpu_torch.serve as serve
assert "nemo_tpu_torch.serve.router" not in sys.modules
from nemo_tpu_torch.obs import federation
from nemo_tpu_torch.serve import autoscale
from nemo_tpu_torch.serve.router import Router, RouterLoopback
from nemo_tpu_torch.service import wire
from nemo_tpu_torch.service.client import RemoteAnalyzer
from nemo_tpu_torch.service.server import Loopback
from nemo_tpu_torch.store.rcache import Lease, ResultCache
assert serve.Router is Router
replicas = [Loopback("cpu", name="a"), Loopback("cpu", name="b")]
router = Router(replicas)
resp = RemoteAnalyzer(RouterLoopback(router)).health()
assert resp["platform"] == "cpu" and set(resp["metrics"]["replicas"]) == {"a", "b"}, resp
router.poll_health()
assert "nemo_fleet_backends_up 2" in federation.federate(*router.fleet_snapshots())
for make in (lambda: RemoteAnalyzer("127.0.0.1:1"), lambda: Router(["127.0.0.1:1", replicas[0]])):
    try:
        make()
    except ImportError:
        print("raised")
"""


def test_fleet_runs_in_process_without_grpc():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _FLEET_WITHOUT_GRPC], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-2:] == ["raised", "raised"]


def test_fleet_replica_child_raises_without_a_card(monkeypatch):
    """A spawned fleet replica asked for cuda where there is none reports the
    failure instead of running on the CPU (chip_smoke.py:fleet_replica, run
    here in this process)."""
    import queue

    from chip_smoke import fleet_replica

    from nemo_tpu_torch.obs import flight

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("NEMO_FLIGHT", "off")  # the replica arms from the env; this process stays unarmed
    out = queue.Queue()
    fleet_replica("replica-0", "cuda", {}, queue.Queue(), out, None)
    assert flight.recorder() is None
    kind, body = out.get_nowait()
    assert kind == "error" and "cuda" in body
