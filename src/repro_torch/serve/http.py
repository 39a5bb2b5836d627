"""OpenAI-style HTTP endpoint over the asyncio serving frontend.

Stdlib-only (``asyncio.start_server`` + a hand-rolled HTTP/1.1 parser —
no web framework dependency), exposing the
:class:`~repro_torch.serve.frontend.AsyncFrontend` as four routes:

* ``POST /v1/completions`` — submit a completion. The request body is
  JSON; ``prompt`` is a **list of int token ids** (this repo serves
  models, it does not ship a tokenizer). With ``"stream": true`` the
  response is Server-Sent Events: one ``data: {...}`` chunk per drained
  token span (``decode_block`` / spec-wave granularity), a final chunk
  carrying ``finish_reason``, then ``data: [DONE]``. Without ``stream``
  the response is a single OpenAI-shaped JSON completion.
* ``GET /v1/stats`` — engine stats snapshot (the
  ``ServeEngine.stats`` key table) plus a ``metrics`` histogram digest,
  JSON.
* ``GET /v1/metrics`` — the same counters in Prometheus text exposition
  format plus TTFT/TPOT/latency histograms (``repro_torch.obs.metrics``),
  ready for a Prometheus scrape job.
* ``GET /health`` — liveness probe, ``{"status": "ok"}``.

``finish_reason`` is ``"length"`` (hit ``max_tokens``), ``"stop"``
(early EOS), or ``"shed"`` (SLO admission control rejected the request —
the non-streaming path also sets HTTP 503 in that case, streaming has
already sent its 200 so the reason string is the signal).

The bodies, status codes and SSE framing are the JAX package's, so its
``docs/serving_api.md`` (the protocol, every knob and its default) and
the clients ``examples/stream_client.py`` and
``examples/scrape_metrics.py`` apply unchanged.
"""
from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional, Tuple

from repro_torch.obs.metrics import CONTENT_TYPE as METRICS_CONTENT_TYPE
from repro_torch.serve.frontend import AsyncFrontend, RequestStream

MAX_BODY_BYTES = 8 << 20        # refuse absurd request bodies (8 MiB)

# completion-request knobs: JSON key -> (submit kwarg, type, default)
_KNOBS = (
    ("max_tokens", "max_new_tokens", int, 32),
    ("temperature", "temperature", float, 0.0),
    ("top_k", "top_k", int, 0),
    ("seed", "seed", int, 0),
    ("eos_id", "eos_id", int, -1),
    ("deadline_ms", "deadline_ms", float, None),
    ("priority", "priority", int, None),
)


class HTTPError(Exception):
    """Routed straight to an error response (status + JSON message)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _parse_completion_body(raw: bytes) -> Tuple[list, Dict, bool]:
    """Validate a ``/v1/completions`` body -> (prompt, submit-kwargs,
    stream?). Raises :class:`HTTPError` (400) on anything malformed.

    >>> _parse_completion_body(b'{"prompt": [1, 2], "stream": true}')
    ([1, 2], {'max_new_tokens': 32, 'temperature': 0.0, 'top_k': 0, 'seed': 0, 'eos_id': -1}, True)
    >>> _parse_completion_body(b'{"prompt": "text"}')
    Traceback (most recent call last):
        ...
    repro_torch.serve.http.HTTPError: 'prompt' must be a non-empty list of int token ids (this server has no tokenizer)
    """
    try:
        body = json.loads(raw)
    except (ValueError, UnicodeDecodeError):
        raise HTTPError(400, "request body is not valid JSON")
    if not isinstance(body, dict):
        raise HTTPError(400, "request body must be a JSON object")
    prompt = body.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) for t in prompt)):
        raise HTTPError(400, "'prompt' must be a non-empty list of int "
                             "token ids (this server has no tokenizer)")
    kwargs: Dict = {}
    for key, kwarg, typ, default in _KNOBS:
        v = body.get(key, default)
        if v is None:
            continue
        try:
            kwargs[kwarg] = typ(v)
        except (TypeError, ValueError):
            raise HTTPError(400, f"'{key}' must be a {typ.__name__}")
    stream = bool(body.get("stream", False))
    return prompt, kwargs, stream


def _finish_reason(handle: RequestStream) -> str:
    req = handle.request
    if req.shed:
        return "shed"
    if len(req.generated) < req.max_new_tokens:
        return "stop"               # early EOS ended the request
    return "length"


def _completion_json(handle: RequestStream, token_ids: list) -> Dict:
    req = handle.request
    return {
        "id": f"cmpl-{req.uid}",
        "object": "text_completion",
        "choices": [{
            "index": 0,
            "token_ids": token_ids,
            "finish_reason": _finish_reason(handle),
        }],
        "usage": {
            "prompt_tokens": int(len(req.prompt)),
            "completion_tokens": len(token_ids),
            "total_tokens": int(len(req.prompt)) + len(token_ids),
        },
    }


def _chunk_json(uid: int, token_ids: list,
                finish_reason: Optional[str]) -> Dict:
    return {
        "id": f"cmpl-{uid}",
        "object": "text_completion.chunk",
        "choices": [{
            "index": 0,
            "token_ids": token_ids,
            "finish_reason": finish_reason,
        }],
    }


class ServeHTTP:
    """The HTTP server. Owns nothing but sockets — engine stepping and
    SLO admission live in the :class:`AsyncFrontend` it wraps.

    Args:
        frontend: a **started** AsyncFrontend (the server does not
            start/stop it; ``launch/serve.py`` composes their
            lifetimes).
        host / port: bind address. Port 0 picks a free port —
            ``self.port`` reports the bound one after :meth:`start`.

    On a tensor-parallel mesh only rank 0 binds a port (its frontend
    takes every request; the other ranks follow its engine steps).
    """

    def __init__(self, frontend: AsyncFrontend, host: str = "127.0.0.1",
                 port: int = 8000):
        self.frontend = frontend
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> "ServeHTTP":
        comm = getattr(self.frontend.engine, "_comm", None)
        if comm is not None and comm.rank != 0:
            raise RuntimeError(f"on a mesh only rank 0 serves HTTP, not "
                               f"rank {comm.rank}")
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def aclose(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def __aenter__(self) -> "ServeHTTP":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    async def serve_forever(self) -> None:
        await self._server.serve_forever()

    # ---- connection handling ----
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, body = await self._read_request(reader)
            except HTTPError as e:
                await self._respond_json(writer, e.status,
                                         {"error": {"message": e.message}})
                return
            try:
                await self._route(method, path, body, writer)
            except HTTPError as e:
                await self._respond_json(writer, e.status,
                                         {"error": {"message": e.message}})
            except ValueError as e:
                # engine-side never-admittable rejection (prompt too long
                # for the configured cache, max_tokens over cap, ...)
                await self._respond_json(writer, 400,
                                         {"error": {"message": str(e)}})
        except (ConnectionError, asyncio.IncompleteReadError):
            pass                      # client went away mid-exchange
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @staticmethod
    async def _read_request(reader) -> Tuple[str, str, bytes]:
        line = await reader.readline()
        if not line:
            raise HTTPError(400, "empty request")
        parts = line.decode("latin-1").split()
        if len(parts) != 3:
            raise HTTPError(400, "malformed request line")
        method, path, _version = parts
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0") or 0)
        if length > MAX_BODY_BYTES:
            raise HTTPError(413, "request body too large")
        body = await reader.readexactly(length) if length else b""
        return method, path.split("?", 1)[0], body

    async def _route(self, method: str, path: str, body: bytes,
                     writer) -> None:
        if path == "/health" and method == "GET":
            await self._respond_json(writer, 200, {"status": "ok"})
        elif path == "/v1/stats" and method == "GET":
            stats = await self.frontend.stats()
            await self._respond_json(writer, 200, stats)
        elif path == "/v1/metrics" and method == "GET":
            # the counters/gauges are a scrape-time projection of the
            # same stats() snapshot /v1/stats serves (see obs.metrics)
            stats = await self.frontend.stats()
            text = self.frontend.engine.metrics.render(stats)
            await self._respond_text(writer, 200, text, METRICS_CONTENT_TYPE)
        elif path == "/v1/completions" and method == "POST":
            prompt, kwargs, stream = _parse_completion_body(body)
            if stream:
                await self._stream_completion(writer, prompt, kwargs)
            else:
                await self._blocking_completion(writer, prompt, kwargs)
        else:
            raise HTTPError(404, f"no route for {method} {path}")

    # ---- the two completion paths ----
    async def _blocking_completion(self, writer, prompt, kwargs) -> None:
        handle = await self.frontend.submit(prompt, **kwargs)
        toks = await handle.tokens()
        status = 503 if handle.shed else 200
        await self._respond_json(writer, status,
                                 _completion_json(handle, toks))

    async def _stream_completion(self, writer, prompt, kwargs) -> None:
        handle = await self.frontend.submit(prompt, **kwargs)
        uid = handle.request.uid
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        # forward spans as they drain; RequestStream yields single tokens,
        # so re-batch per queue burst to keep one SSE event per harvest
        pending: list = []
        async for tok in handle:
            pending.append(tok)
            if handle._queue.empty():
                await self._send_event(writer, _chunk_json(uid, pending,
                                                           None))
                pending = []
        final = _chunk_json(uid, pending, _finish_reason(handle))
        await self._send_event(writer, final)
        writer.write(b"data: [DONE]\n\n")
        await writer.drain()

    # ---- response plumbing ----
    @staticmethod
    async def _send_event(writer, obj: Dict) -> None:
        writer.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
        await writer.drain()

    @staticmethod
    async def _respond_json(writer, status: int, obj: Dict) -> None:
        await ServeHTTP._respond_text(writer, status, json.dumps(obj),
                                      "application/json")

    @staticmethod
    async def _respond_text(writer, status: int, text: str,
                            content_type: str) -> None:
        payload = text.encode()
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  413: "Payload Too Large",
                  503: "Service Unavailable"}.get(status, "Error")
        writer.write(f"HTTP/1.1 {status} {reason}\r\n"
                     f"Content-Type: {content_type}\r\n"
                     f"Content-Length: {len(payload)}\r\n"
                     f"Connection: close\r\n\r\n".encode() + payload)
        await writer.drain()
