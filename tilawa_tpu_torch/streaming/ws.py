"""Minimal RFC 6455 WebSocket server/client over asyncio streams.

The reference serves streaming recognition over FastAPI/uvicorn WebSockets
(reference: web/server.py). Neither is available in this environment, so
this module implements the needed subset natively: HTTP upgrade handshake,
frame encode/decode (text/binary/ping/pong/close), client masking, and
fragmented-message reassembly. No extensions, no TLS.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import struct
from dataclasses import dataclass

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA


class WebSocketError(RuntimeError):
    pass


class ConnectionClosed(WebSocketError):
    pass


def _accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + GUID).encode()).digest()
    ).decode()


def encode_frame(opcode: int, payload: bytes, mask: bool = False) -> bytes:
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < 1 << 16:
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


async def read_frame(reader: asyncio.StreamReader) -> tuple[int, bool, bytes]:
    """Returns (opcode, fin, payload) with unmasking applied."""
    try:
        b0, b1 = await reader.readexactly(2)
    except (asyncio.IncompleteReadError, ConnectionResetError) as e:
        raise ConnectionClosed("stream ended") from e
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack(">Q", await reader.readexactly(8))
    key = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(n) if n else b""
    if key:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, fin, payload


@dataclass
class Message:
    opcode: int
    data: bytes

    @property
    def is_text(self) -> bool:
        return self.opcode == OP_TEXT

    @property
    def text(self) -> str:
        return self.data.decode("utf-8")


class WebSocket:
    """One established connection (either side)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 client_side: bool = False):
        self.reader = reader
        self.writer = writer
        self.client_side = client_side
        self.closed = False

    async def send_text(self, text: str) -> None:
        await self._send(OP_TEXT, text.encode("utf-8"))

    async def send_bytes(self, data: bytes) -> None:
        await self._send(OP_BINARY, data)

    async def _send(self, opcode: int, payload: bytes) -> None:
        if self.closed:
            raise ConnectionClosed("already closed")
        self.writer.write(encode_frame(opcode, payload, mask=self.client_side))
        await self.writer.drain()

    async def receive(self) -> Message:
        """Next data message (handles ping/pong/fragmentation/close)."""
        buffer = b""
        first_opcode: int | None = None
        while True:
            opcode, fin, payload = await read_frame(self.reader)
            if opcode == OP_PING:
                await self._send(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                await self.close()
                raise ConnectionClosed("peer closed")
            if opcode in (OP_TEXT, OP_BINARY):
                first_opcode = opcode
                buffer = payload
            elif opcode == OP_CONT:
                buffer += payload
            if fin:
                return Message(first_opcode or OP_BINARY, buffer)

    async def close(self, code: int = 1000) -> None:
        if not self.closed:
            self.closed = True
            try:
                self.writer.write(
                    encode_frame(OP_CLOSE, struct.pack(">H", code),
                                 mask=self.client_side)
                )
                await self.writer.drain()
            except Exception:  # noqa: BLE001
                pass
            self.writer.close()


async def serve(handler, host: str = "127.0.0.1", port: int = 8765,
                path: str = "/ws", http_handler=None):
    """Start a WebSocket server; handler(ws: WebSocket, path: str).

    Non-upgrade HTTP requests are routed to `http_handler(method, path,
    headers, body) -> (status:int, content_type:str, body:bytes)` when
    given (the REST surface: /api/status, /api/surah/{n}, /api/reports,
    /api/diagnostics — reference: web/server.py:1038-1059 +
    web/frontend/server/index.ts:25-44), else answered 400."""

    async def on_connect(reader, writer):
        try:
            request = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                ConnectionResetError):
            writer.close()
            return
        lines = request.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        method = parts[0] if parts else "GET"
        req_path = parts[1] if len(parts) > 1 else "/"
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        key = headers.get("sec-websocket-key")
        if headers.get("upgrade", "").lower() != "websocket" or not key:
            if http_handler is not None:
                try:
                    body = b""
                    clen = int(headers.get("content-length", "0") or 0)
                    if clen > 0:
                        body = await reader.readexactly(clen)
                    status, ctype, payload = await http_handler(
                        method, req_path, headers, body
                    )
                except Exception:
                    status, ctype, payload = 500, "text/plain", b"internal error"
                reason = {200: "OK", 201: "Created", 404: "Not Found",
                          400: "Bad Request", 500: "Internal Server Error"}.get(
                    status, "OK")
                writer.write(
                    (
                        f"HTTP/1.1 {status} {reason}\r\n"
                        f"Content-Type: {ctype}\r\n"
                        f"Content-Length: {len(payload)}\r\n"
                        "Connection: close\r\n\r\n"
                    ).encode("latin-1") + payload
                )
                await writer.drain()
                writer.close()
                return
            writer.write(b"HTTP/1.1 400 Bad Request\r\n\r\n")
            await writer.drain()
            writer.close()
            return
        writer.write(
            (
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {_accept_key(key)}\r\n\r\n"
            ).encode("latin-1")
        )
        await writer.drain()
        ws = WebSocket(reader, writer)
        try:
            await handler(ws, req_path)
        except ConnectionClosed:
            pass
        finally:
            await ws.close()

    return await asyncio.start_server(on_connect, host, port)


async def connect(host: str, port: int, path: str = "/ws") -> WebSocket:
    reader, writer = await asyncio.open_connection(host, port)
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write(
        (
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n"
        ).encode("latin-1")
    )
    await writer.drain()
    response = await reader.readuntil(b"\r\n\r\n")
    status = response.split(b"\r\n", 1)[0]
    if b"101" not in status:
        raise WebSocketError(f"handshake failed: {status!r}")
    return WebSocket(reader, writer, client_side=True)
