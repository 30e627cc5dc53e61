"""nemo_tpu_torch: the provenance-graph debugger's analysis path in PyTorch,
with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

A port of the JAX package ``nemo_tpu`` that imports nothing of it: the
host-side modules it needs (ingest, packing, corpus generators, prototype
set algebra) are copies, and every device module is a PyTorch rewrite held
bit for bit against its JAX counterpart by ``tests/test_torch_*.py``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

Beside the card's path stand the host tools, which run no device code:
``dedalus/`` (the mini-Dedalus fault injector, ``python -m
nemo_tpu_torch.dedalus``, which writes Molly-format sweeps),
``backend/python_ref.py`` (the property-graph oracle) and
``backend/neo4j_backend.py`` over the port's Bolt client ``backend/bolt/``
(``--graph-backend python|neo4j``).

``resolve_device`` is imported at first use (a module ``__getattr__``), so
that importing a torch-free layer such as ``nemo_tpu_torch.report`` loads
no torch.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    if name == "resolve_device":
        from nemo_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
