"""Pure-Python Bolt v1 driver (the reference vendors a Go equivalent,
vendor/github.com/johnnadratowski/golang-neo4j-bolt-driver, ~3.8k LoC —
conn.go:35-60 is the interface our client mirrors)."""

from nemo_tpu_torch.backend.bolt.client import BoltConnection, BoltError
from nemo_tpu_torch.backend.bolt.packstream import Node, Path, Relationship, pack, unpack

__all__ = [
    "BoltConnection",
    "BoltError",
    "Node",
    "Relationship",
    "Path",
    "pack",
    "unpack",
]
