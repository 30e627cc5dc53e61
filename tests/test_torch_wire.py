"""The port's wire (nemo_tpu_torch/service/wire.py) against protobuf's
generated classes (the JAX package's service/proto/nemo_service_pb2.py).

* every one of the nine messages round-trips through its own bytes;
* the port's bytes equal ``SerializeToString(deterministic=True)`` of the
  same message built with pb2, over hypothesis-drawn dtypes, shapes, map
  keys, params and doubles; each side parses the other's bytes into an
  equal message;
* a parse skips unknown fields and reads a repeated int64 packed or not,
  and malformed bytes raise;
* the codecs agree: the port's codec and the JAX package's encode the same
  arrays to the same bytes, and decode each other's;
* the service and serve modules import with grpc and google.protobuf
  absent.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from nemo_tpu.service import codec as jax_codec
from nemo_tpu.service.proto import nemo_service_pb2 as pb2
from nemo_tpu_torch.service import codec
from nemo_tpu_torch.service import wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "float32", "float64")


def _det(m) -> bytes:
    return m.SerializeToString(deterministic=True)


@st.composite
def arrays(draw):
    dtype = draw(st.sampled_from(DTYPES))
    shape = tuple(draw(st.lists(st.integers(0, 5), min_size=0, max_size=3)))
    n = int(np.prod(shape, dtype=np.int64))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    if dtype == "bool":
        a = rng.random(n) < 0.5
    elif dtype.startswith("float"):
        a = rng.standard_normal(n)
    else:
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    return a.astype(dtype).reshape(shape)


keys = st.text(alphabet=st.characters(codec="utf-8", exclude_categories=("Cs",)), max_size=6)
int64s = st.integers(-(2**63), 2**63 - 1)
doubles = st.floats(allow_nan=False)


def _pb2_ndarray(a) -> "pb2.NdArray":
    return jax_codec.ndarray_to_pb(a)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(verb=keys, arrs=st.dictionaries(keys, arrays(), max_size=4), params=st.dictionaries(keys, int64s, max_size=4))
def test_kernel_request_bytes_equal_pb2_deterministic(verb, arrs, params):
    port = codec.kernel_request_to_pb(verb, arrs, params)
    theirs = jax_codec.kernel_request_to_pb(verb, arrs, params)
    b = port.SerializeToString()
    assert b == _det(theirs)
    assert wire.KernelRequest.FromString(b) == port
    assert wire.KernelRequest.FromString(theirs.SerializeToString()) == port
    assert _det(pb2.KernelRequest.FromString(b)) == b
    v, a2, p2 = codec.kernel_request_from_pb(wire.KernelRequest.FromString(b))
    assert v == verb and p2 == {k: int(x) for k, x in params.items()}
    for k, x in arrs.items():
        # A 0-d array travels as shape [1], as both codecs send it
        # (np.ascontiguousarray gives at least one dim).
        want = np.ascontiguousarray(x)
        got = a2[k]
        assert got.shape == want.shape and got.dtype == want.dtype and np.array_equal(got, want)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(outs=st.dictionaries(keys, arrays(), max_size=4), step=doubles, chunk=int64s)
def test_responses_bytes_equal_pb2_deterministic(outs, step, chunk):
    port = codec.kernel_response_to_pb(outs, step)
    theirs = jax_codec.kernel_response_to_pb(outs, step)
    assert port.SerializeToString() == _det(theirs)
    assert wire.KernelResponse.FromString(_det(theirs)) == port
    port = codec.outputs_to_pb(outs, chunk, step)
    theirs = jax_codec.outputs_to_pb(outs, chunk, step)
    assert port.SerializeToString() == _det(theirs)
    back = wire.AnalyzeResponse.FromString(theirs.SerializeToString())
    assert back == port
    assert back.chunk == chunk and (back.step_seconds == step or (step == 0 and back.step_seconds == 0))


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(fields=st.lists(arrays(), min_size=8, max_size=8), static=st.lists(int64s, min_size=7, max_size=7),
       chunk=int64s, with_post=st.booleans())
def test_analyze_request_bytes_equal_pb2(fields, static, chunk, with_post):
    names = [f for _, f, _ in wire.CondBatch.FIELDS]
    batch = dict(zip(names, fields))
    st_names = [f for _, f, _ in wire.StaticParams.FIELDS]
    sp = dict(zip(st_names, static))
    port = wire.AnalyzeRequest(pre=wire.CondBatch(**{k: codec.ndarray_to_pb(v) for k, v in batch.items()}),
                               static=wire.StaticParams(**sp), chunk=chunk)
    theirs = pb2.AnalyzeRequest(pre=pb2.CondBatch(**{k: _pb2_ndarray(v) for k, v in batch.items()}),
                                static=pb2.StaticParams(**sp), chunk=chunk)
    if with_post:
        port.post = wire.CondBatch()
        theirs.post.CopyFrom(pb2.CondBatch())
    b = port.SerializeToString()
    assert b == _det(theirs)
    assert wire.AnalyzeRequest.FromString(b) == port
    assert _det(pb2.AnalyzeRequest.FromString(b)) == b


@given(platform=keys, count=st.integers(-(2**31), 2**31 - 1), version=keys)
def test_health_bytes_equal_pb2(platform, count, version):
    port = wire.HealthResponse(platform=platform, device_count=count, version=version)
    theirs = pb2.HealthResponse(platform=platform, device_count=count, version=version)
    assert port.SerializeToString() == _det(theirs)
    assert wire.HealthResponse.FromString(theirs.SerializeToString()) == port
    assert wire.HealthRequest().SerializeToString() == _det(pb2.HealthRequest()) == b""


@pytest.mark.parametrize("cls", wire.MESSAGES, ids=lambda c: c.__name__)
def test_every_message_round_trips_and_matches_pb2_defaults(cls):
    """Each message at its defaults and with every field set: its bytes
    read back equal, and protobuf reads them into the same fields."""
    assert cls.FromString(cls().SerializeToString()) == cls()
    assert cls().SerializeToString() == _det(getattr(pb2, cls.__name__)())
    kw = {}
    for _, name, kind in cls.FIELDS:
        if isinstance(kind, tuple):
            kw[name] = {"b": wire.NdArray(dtype="int32", shape=[1], data=b"\x01\0\0\0"), "a": wire.NdArray()} \
                if kind[2] is wire.NdArray else {"b": -3, "a": 0}
        elif isinstance(kind, type):
            kw[name] = kind()
        else:
            kw[name] = {"string": "xé", "bytes": b"\x00\xff", "int64": -5, "int32": -7, "double": -0.5,
                        "rep_int64": [0, -1, 2**40]}[kind]
    m = cls(**kw)
    b = m.SerializeToString()
    assert cls.FromString(b) == m
    theirs = getattr(pb2, cls.__name__).FromString(b)
    assert _det(theirs) == b


def test_parse_skips_unknown_fields_and_reads_unpacked_repeated():
    m = wire.NdArray(dtype="int8", shape=[2, 3], data=b"\x01\x02")
    b = m.SerializeToString()
    # Unknown fields of every wire type: varint 9, fixed64 10, bytes 11, fixed32 12.
    extra = bytes([9 << 3 | 0, 0x96, 0x01, 10 << 3 | 1]) + bytes(8) + bytes([11 << 3 | 2, 2, 0x61, 0x62]) \
        + bytes([12 << 3 | 5]) + bytes(4)
    assert wire.NdArray.FromString(extra + b + extra) == m
    # shape as unpacked varints (field 2, wire type 0), as an old writer may send.
    unpacked = bytes([2 << 3 | 0, 2, 2 << 3 | 0, 3])
    assert wire.NdArray.FromString(unpacked).shape == [2, 3]
    assert pb2.NdArray.FromString(unpacked).shape == [2, 3]


@pytest.mark.parametrize("bad", [b"\x0a\x05ab", b"\x08", b"\x0a", b"\x09\x01\x02", b"\x0b", b"\x00\x01",
                                 b"\x12\x03\xff\xff\xff"])
def test_malformed_bytes_raise(bad):
    with pytest.raises(wire.DecodeError):
        wire.NdArray.FromString(bad)
    with pytest.raises(Exception):
        pb2.NdArray.FromString(bad)


def test_map_order_is_upb_deterministic_order():
    """Map entries go out in the order protobuf's upb runtime writes them
    under deterministic=True: bytes ascending, a key after every longer key
    it begins."""
    ks = ["b", "a", "ab", "", "B", "aa", "z", "zz", "é", "a\x00"]
    port = wire.KernelRequest(params={k: 1 for k in ks})
    theirs = pb2.KernelRequest()
    for k in ks:
        theirs.params[k] = 1
    assert port.SerializeToString() == _det(theirs)


def test_codecs_decode_each_others_arrays():
    rng = np.random.default_rng(0)
    for a in (rng.random((3, 5)) < 0.5, rng.integers(-9, 9, (4, 2), dtype=np.int32), np.zeros((0, 3), np.int64)):
        mine, theirs = codec.ndarray_to_pb(a), jax_codec.ndarray_to_pb(a)
        assert mine.SerializeToString() == _det(theirs)
        np.testing.assert_array_equal(codec.ndarray_from_pb(wire.NdArray.FromString(theirs.SerializeToString())), a)
        np.testing.assert_array_equal(jax_codec.ndarray_from_pb(pb2.NdArray.FromString(mine.SerializeToString())), a)
    static = {"v": 32, "pre_tid": 0, "post_tid": 1, "num_tables": 16, "num_labels": 64, "max_depth": 16,
              "comp_linear": True}
    assert codec.static_from_pb(wire.StaticParams.FromString(_det(jax_codec.static_to_pb(static)))) == static


_IMPORT_WITHOUT_GRPC = """
import sys
sys.modules["grpc"] = None
sys.modules["google.protobuf"] = None
import nemo_tpu_torch.service.wire, nemo_tpu_torch.service.codec, nemo_tpu_torch.service.server
import nemo_tpu_torch.service.client, nemo_tpu_torch.backend.service_backend
import nemo_tpu_torch.serve, nemo_tpu_torch.serve.batch, nemo_tpu_torch.utils.subproc
from nemo_tpu_torch.service.client import RemoteAnalyzer
try:
    RemoteAnalyzer("127.0.0.1:1")
except ImportError:
    print("host:port raises")
print(sorted(k for k, m in sys.modules.items() if m is not None and k.startswith(("grpc", "google.protobuf", "jax",
                                                                                 "nemo_tpu."))))
"""


def test_service_modules_import_without_grpc_or_protobuf():
    """The transport alone imports grpc: the modules import where grpc and
    protobuf are absent, and a host:port target then raises instead of
    falling back to anything."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_WITHOUT_GRPC], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["host:port raises", "[]"]
