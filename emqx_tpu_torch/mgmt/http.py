"""Dependency-free asyncio HTTP/1.1 server — the minirest analog (the
port's own copy of emqx_tpu/mgmt/http.py).

Routes are `(method, "/api/v5/clients/{clientid}")` patterns; path
params land in `req.params`. Handlers may be sync or async and return
a `Response`, a `(status, json_obj)` pair, or a bare json-serializable
object (200). Keep-alive is supported; bodies are bounded. A handler
that reaches a subsystem the port has not ported yet raises
`NotPortedError`; the dispatcher answers it here, in one place, as
HTTP 501 with code NOT_PORTED and the ROADMAP item in the message.
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

from ..config.unported import NotPortedError

log = logging.getLogger("emqx_tpu_torch.mgmt.http")

MAX_BODY = 8 << 20
MAX_HEADER = 64 << 10


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, str]
    headers: Dict[str, str]
    body: bytes
    params: Dict[str, str] = field(default_factory=dict)
    # decoded path segments (%2F inside one id stays INSIDE it)
    path_segments: Optional[list] = None
    # set by auth middleware
    principal: Optional[str] = None

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json"
    headers: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def json(cls, obj: Any, status: int = 200) -> "Response":
        return cls(status=status, body=json.dumps(obj).encode("utf-8"))

    @classmethod
    def text(cls, s: str, status: int = 200) -> "Response":
        return cls(status=status, body=s.encode("utf-8"), content_type="text/plain")

    @classmethod
    def error(cls, status: int, code: str, message: str) -> "Response":
        return cls.json({"code": code, "message": message}, status=status)


_REASONS = {
    200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
    401: "Unauthorized", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 412: "Precondition Failed",
    500: "Internal Server Error", 501: "Not Implemented",
}


class _Route:
    def __init__(self, method: str, pattern: str, handler: Callable):
        self.method = method
        self.pattern = pattern
        self.handler = handler
        self.segs = pattern.strip("/").split("/") if pattern.strip("/") else []

    def match(self, path_segs: List[str]) -> Optional[Dict[str, str]]:
        # a trailing "{param...}" segment swallows the rest of the path
        # (config paths contain dots/slashes)
        if self.segs and self.segs[-1].endswith("...}"):
            if len(path_segs) < len(self.segs):
                return None
        elif len(self.segs) != len(path_segs):
            return None
        params: Dict[str, str] = {}
        for i, seg in enumerate(self.segs):
            if seg.startswith("{") and seg.endswith("...}"):
                params[seg[1:-4]] = "/".join(path_segs[i:])
                return params
            if seg.startswith("{") and seg.endswith("}"):
                params[seg[1:-1]] = path_segs[i]
            elif i >= len(path_segs) or seg != path_segs[i]:
                return None
        return params


class HttpServer:
    def __init__(self) -> None:
        self._routes: List[_Route] = []
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self.listen_addr: Optional[Tuple[str, int]] = None
        # middleware: (req) -> Optional[Response]; a Response short-circuits
        self.before: List[Callable[[Request], Optional[Response]]] = []
        # observers: (req, resp) -> None, after every dispatched request
        self.after: List[Callable[[Request, Response], None]] = []

    def route(self, method: str, pattern: str, handler: Callable) -> None:
        self._routes.append(_Route(method.upper(), pattern, handler))

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._serve, host, port)
        self.listen_addr = self._server.sockets[0].getsockname()[:2]
        return self.listen_addr

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for _ in range(3):
                for w in list(self._conns):
                    w.close()
                await asyncio.sleep(0)
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except asyncio.TimeoutError:
                pass
            self._server = None

    async def _serve(self, reader, writer) -> None:
        self._conns.add(writer)
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                resp = await self._handle(req)
                for obs in self.after:
                    try:
                        obs(req, resp)
                    except Exception:
                        log.exception("after-middleware failed")
                data = (
                    f"HTTP/1.1 {resp.status} {_REASONS.get(resp.status, '')}\r\n"
                    f"content-type: {resp.content_type}\r\n"
                    f"content-length: {len(resp.body)}\r\n"
                ).encode()
                for k, v in resp.headers.items():
                    data += f"{k}: {v}\r\n".encode()
                data += b"\r\n" + resp.body
                writer.write(data)
                await writer.drain()
                if req.headers.get("connection", "").lower() == "close":
                    break
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.LimitOverrunError):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _read_request(self, reader) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        if len(head) > MAX_HEADER:
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _ver = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or "0")
        if n > MAX_BODY:
            return None
        body = await reader.readexactly(n) if n else b""
        parts = urlsplit(target)
        query = dict(parse_qsl(parts.query))
        # decode PER SEGMENT, after splitting: unquoting the whole
        # path first turns an encoded '/' inside an id (clientid
        # "tenant%2Fdev1") into a path separator and the route misses
        segs = [unquote(s) for s in parts.path.split("/")]
        return Request(
            method=method.upper(),
            path="/".join(segs),
            query=query,
            headers=headers,
            body=body,
            path_segments=[s for s in segs if s],
        )

    async def _handle(self, req: Request) -> Response:
        path_segs = (
            req.path_segments
            if req.path_segments is not None
            else (req.path.strip("/").split("/") if req.path.strip("/") else [])
        )
        matched_path = False
        for r in self._routes:
            params = r.match(path_segs)
            if params is None:
                continue
            matched_path = True
            if r.method != req.method:
                continue
            req.params = params
            try:
                for mw in self.before:
                    early = mw(req)
                    if early is not None:
                        return early
                out = r.handler(req)
                if asyncio.iscoroutine(out):
                    out = await out
            except NotPortedError as e:
                return Response.error(501, "NOT_PORTED", str(e))
            except json.JSONDecodeError:
                return Response.error(400, "BAD_REQUEST", "invalid json body")
            except ValueError as e:
                return Response.error(400, "BAD_REQUEST", str(e))
            except Exception as e:
                log.exception("handler error %s %s", req.method, req.path)
                return Response.error(500, "INTERNAL_ERROR", repr(e))
            if isinstance(out, Response):
                return out
            if isinstance(out, tuple):
                status, obj = out
                if obj is None:
                    return Response(status=status)
                return Response.json(obj, status=status)
            return Response.json(out)
        if matched_path:
            return Response.error(405, "METHOD_NOT_ALLOWED", req.method)
        return Response.error(404, "NOT_FOUND", req.path)
