"""numpy and torch arrays <-> the sidecar's wire messages (service/wire.py).

A copy of the JAX package's ``service/codec.py`` over the port's own wire
classes: a bool array travels bit-packed under the dtype tag
``packedbool`` (8x fewer bytes), every other array as its C-order bytes
under its numpy dtype name.  The server builds its batches with torch on
its own device (``batch_arrays_from_pb``), where the JAX codec builds
``jax.numpy`` arrays.  A tensor to encode is copied to the host first:
the wire carries no device handles.
"""

from __future__ import annotations

import numpy as np

from nemo_tpu_torch.service import wire as pb

_COND_FIELDS = (
    "table_id",
    "label_id",
    "type_id",
    "is_goal",
    "node_mask",
    "edge_src",
    "edge_dst",
    "edge_mask",
)

#: The dtype tag of a bit-packed bool array; a peer that does not know it
#: fails on decode rather than misread the bytes.
_PACKED_BOOL = "packedbool"


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a torch tensor, on any device
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a))


def ndarray_to_pb(a) -> pb.NdArray:
    a = _host(a)
    if a.dtype == np.bool_:
        return pb.NdArray(dtype=_PACKED_BOOL, shape=list(a.shape), data=np.packbits(a).tobytes())
    return pb.NdArray(dtype=str(a.dtype), shape=list(a.shape), data=a.tobytes())


def ndarray_from_pb(m: pb.NdArray, copy: bool = False) -> np.ndarray:
    """Decode to numpy: a read-only view of the message's bytes unless
    ``copy`` (bool arrays are always unpacked into a new array)."""
    shape = tuple(m.shape)
    if m.dtype == _PACKED_BOOL:
        n = int(np.prod(shape, dtype=np.int64))
        bits = np.unpackbits(np.frombuffer(m.data, dtype=np.uint8), count=n)
        return bits.astype(bool).reshape(shape)
    a = np.frombuffer(m.data, dtype=np.dtype(m.dtype)).reshape(shape)
    return a.copy() if copy else a


def batch_arrays_to_pb(arrays) -> pb.CondBatch:
    """BatchArrays (or any object with the 8 packed fields) -> CondBatch."""
    return pb.CondBatch(**{f: ndarray_to_pb(getattr(arrays, f)) for f in _COND_FIELDS})


def batch_arrays_from_pb(m: pb.CondBatch, device=None):
    """CondBatch -> the port's BatchArrays on ``device`` (None: cuda)."""
    from nemo_tpu_torch.models.pipeline_model import batch_from_numpy

    return batch_from_numpy({f: ndarray_from_pb(getattr(m, f)) for f in _COND_FIELDS}, device)


def static_to_pb(static: dict) -> pb.StaticParams:
    return pb.StaticParams(**{k: int(v) for k, v in static.items()})


def static_from_pb(m: pb.StaticParams) -> dict:
    return dict(
        v=int(m.v),
        pre_tid=int(m.pre_tid),
        post_tid=int(m.post_tid),
        num_tables=int(m.num_tables),
        num_labels=int(m.num_labels),
        max_depth=int(m.max_depth),
        comp_linear=bool(m.comp_linear),
    )


def kernel_request_to_pb(verb: str, arrays: dict, params: dict) -> pb.KernelRequest:
    return pb.KernelRequest(
        verb=verb,
        arrays={k: ndarray_to_pb(v) for k, v in arrays.items() if v is not None},
        params={k: int(v) for k, v in params.items()},
    )


def kernel_request_from_pb(m: pb.KernelRequest) -> tuple[str, dict, dict]:
    arrays = {k: ndarray_from_pb(v) for k, v in m.arrays.items()}
    params = {k: int(v) for k, v in m.params.items()}
    return m.verb, arrays, params


def kernel_response_to_pb(outputs: dict, step_seconds: float) -> pb.KernelResponse:
    return pb.KernelResponse(outputs={k: ndarray_to_pb(v) for k, v in outputs.items()}, step_seconds=step_seconds)


def kernel_response_from_pb(m: pb.KernelResponse) -> dict[str, np.ndarray]:
    return {k: ndarray_from_pb(v) for k, v in m.outputs.items()}


def outputs_to_pb(outputs: dict, chunk: int, step_seconds: float) -> pb.AnalyzeResponse:
    return pb.AnalyzeResponse(outputs={k: ndarray_to_pb(v) for k, v in outputs.items()}, chunk=chunk,
                              step_seconds=step_seconds)


def outputs_from_pb(m: pb.AnalyzeResponse) -> dict[str, np.ndarray]:
    return {k: ndarray_from_pb(v) for k, v in m.outputs.items()}
