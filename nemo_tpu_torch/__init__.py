"""nemo_tpu_torch: the provenance-graph debugger's analysis path in PyTorch,
with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

A port of the JAX package ``nemo_tpu`` that imports nothing of it: the
host-side modules it needs (ingest, packing, corpus generators, prototype
set algebra) are copies, and every device module is a PyTorch rewrite held
bit for bit against its JAX counterpart by ``tests/test_torch_*.py``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

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
