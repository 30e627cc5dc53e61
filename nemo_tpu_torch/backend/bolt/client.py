"""Bolt v1 connection: handshake, chunked message framing, request/response.

Speaks the public Bolt v1 protocol (what Neo4j 3.3 serves on port 7687;
the reference's vendored Go driver implements the same wire format —
conn.go:35-60 is the `Conn` interface whose Prepare/Query/Exec surface
`BoltConnection.run` replaces).  The backend opens two connections, matching
the reference's Conn1/Conn2 pair (graphing/helpers.go:38-49).

Wire format summary (public spec):
  handshake:  C->S  60:60:B0:17 + four big-endian uint32 version proposals
              S->C  one uint32: the agreed version (0 = refused)
  messages:   PackStream structures, split into chunks; each chunk is a
              2-byte big-endian size header + payload; a zero-size chunk
              terminates the message.
  requests:   INIT 0x01, RUN 0x10, PULL_ALL 0x3F, DISCARD_ALL 0x2F,
              RESET 0x0F, ACK_FAILURE 0x0E
  responses:  SUCCESS 0x70, RECORD 0x71, IGNORED 0x7E, FAILURE 0x7F
"""

from __future__ import annotations

import socket
import struct
from typing import Any
from urllib.parse import unquote, urlparse

from nemo_tpu_torch.backend.bolt.packstream import Structure, pack, unpack_all

BOLT_MAGIC = b"\x60\x60\xb0\x17"
BOLT_VERSION = 1

MSG_INIT = 0x01
MSG_ACK_FAILURE = 0x0E
MSG_RESET = 0x0F
MSG_RUN = 0x10
MSG_DISCARD_ALL = 0x2F
MSG_PULL_ALL = 0x3F
MSG_SUCCESS = 0x70
MSG_RECORD = 0x71
MSG_IGNORED = 0x7E
MSG_FAILURE = 0x7F

MAX_CHUNK = 0xFFFF
DEFAULT_USER_AGENT = "nemo-tpu/bolt-python"


class BoltError(RuntimeError):
    """Server FAILURE response or protocol violation."""

    def __init__(self, code: str, message: str) -> None:
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


class BoltConnection:
    """One Bolt session over TCP.  Not thread-safe; open one per logical
    connection (the reference needs two, graphing/helpers.go:38-49)."""

    def __init__(
        self,
        uri: str = "bolt://127.0.0.1:7687",
        auth: tuple[str, str] | None = None,
        timeout: float = 600.0,
        user_agent: str = DEFAULT_USER_AGENT,
    ) -> None:
        parsed = urlparse(uri)
        if parsed.scheme not in ("bolt", ""):
            raise ValueError(f"unsupported scheme {parsed.scheme!r} (expected bolt://)")
        host = parsed.hostname or "127.0.0.1"
        port = parsed.port or 7687
        if auth is None and parsed.username:
            # urlparse leaves userinfo percent-encoded; decode so passwords
            # with special characters (p%40ss -> p@ss) authenticate.
            auth = (unquote(parsed.username), unquote(parsed.password or ""))
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""
        try:
            self._handshake()
            self._init(user_agent, auth)
        except BaseException:
            self._sock.close()
            raise

    # ------------------------------------------------------------- lifecycle

    def _handshake(self) -> None:
        proposals = struct.pack(">IIII", BOLT_VERSION, 0, 0, 0)
        self._sock.sendall(BOLT_MAGIC + proposals)
        agreed = struct.unpack(">I", self._recv_exact(4))[0]
        if agreed != BOLT_VERSION:
            raise BoltError(
                "ProtocolError", f"server refused Bolt v{BOLT_VERSION} (answered {agreed})"
            )

    def _init(self, user_agent: str, auth: tuple[str, str] | None) -> None:
        token: dict[str, Any] = {"scheme": "none"}
        if auth is not None:
            token = {"scheme": "basic", "principal": auth[0], "credentials": auth[1]}
        self._send_message(Structure(MSG_INIT, [user_agent, token]))
        self._expect_success()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "BoltConnection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- messaging

    def run(
        self, statement: str, params: dict[str, Any] | None = None
    ) -> tuple[list[str], list[list[Any]]]:
        """Execute one statement, pull all records.
        Returns (field_names, records)."""
        self._send_message(Structure(MSG_RUN, [statement, params or {}]))
        self._send_message(Structure(MSG_PULL_ALL, []))
        head = self._recv_message()
        if head.signature == MSG_FAILURE:
            # Server enters FAILED state: the pipelined PULL_ALL comes back
            # IGNORED; consume it before recovering with ACK_FAILURE.
            self._recv_message()
            self._ack_failure()
            meta = head.fields[0] if head.fields else {}
            raise BoltError(meta.get("code", "Unknown"), meta.get("message", ""))
        if head.signature != MSG_SUCCESS:
            raise BoltError("ProtocolError", f"unexpected signature 0x{head.signature:02X}")
        fields = (head.fields[0] if head.fields else {}).get("fields", [])
        records: list[list[Any]] = []
        while True:
            msg = self._recv_message()
            if msg.signature == MSG_RECORD:
                records.append(msg.fields[0])
            elif msg.signature == MSG_SUCCESS:
                return fields, records
            elif msg.signature == MSG_FAILURE:
                self._ack_failure()
                meta = msg.fields[0] if msg.fields else {}
                raise BoltError(meta.get("code", "Unknown"), meta.get("message", ""))
            elif msg.signature == MSG_IGNORED:
                raise BoltError("Ignored", "statement ignored (connection in failed state)")
            else:
                raise BoltError("ProtocolError", f"unexpected signature 0x{msg.signature:02X}")

    def exec(self, statement: str, params: dict[str, Any] | None = None) -> list[list[Any]]:
        """run() returning just the records."""
        return self.run(statement, params)[1]

    def reset(self) -> None:
        self._send_message(Structure(MSG_RESET, []))
        self._expect_success()

    # -------------------------------------------------------------- framing

    def _send_message(self, msg: Structure) -> None:
        payload = pack(msg)
        out = bytearray()
        for ofs in range(0, len(payload), MAX_CHUNK):
            chunk = payload[ofs : ofs + MAX_CHUNK]
            out += struct.pack(">H", len(chunk))
            out += chunk
        out += b"\x00\x00"
        self._sock.sendall(bytes(out))

    def _recv_message(self) -> Structure:
        payload = bytearray()
        while True:
            size = struct.unpack(">H", self._recv_exact(2))[0]
            if size == 0:
                if payload:
                    break
                continue  # NOOP chunk (keep-alive)
            payload += self._recv_exact(size)
        msg = unpack_all(bytes(payload))
        if not isinstance(msg, Structure):
            raise BoltError("ProtocolError", f"non-structure message: {type(msg).__name__}")
        return msg

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            data = self._sock.recv(65536)
            if not data:
                raise BoltError("ConnectionError", "server closed the connection")
            self._buf += data
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _expect_success(self) -> dict[str, Any]:
        msg = self._recv_message()
        if msg.signature == MSG_SUCCESS:
            return msg.fields[0] if msg.fields else {}
        if msg.signature == MSG_FAILURE:
            self._ack_failure()
            meta = msg.fields[0] if msg.fields else {}
            raise BoltError(meta.get("code", "Unknown"), meta.get("message", ""))
        raise BoltError("ProtocolError", f"unexpected signature 0x{msg.signature:02X}")

    def _ack_failure(self) -> None:
        try:
            self._send_message(Structure(MSG_ACK_FAILURE, []))
            msg = self._recv_message()
            if msg.signature not in (MSG_SUCCESS, MSG_IGNORED):
                raise BoltError("ProtocolError", "bad ACK_FAILURE response")
        except OSError:
            pass
