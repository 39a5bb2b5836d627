"""The serving frontend at tp=2 on the CPU: rank 0 hosts ``AsyncFrontend``
and ``ServeHTTP``, the other rank runs ``ServeEngine.follow``.

One ``launch.mesh.spawn_tp`` over gloo runs a session on reduced
qwen2.5-3b (dense, w4a8) against the same session at tp=1 in this
process: pass 1, four SSE streams and one blocking completion through
HTTP, submitted in a fixed order (greedy and sampled); pass 2, on the
same engine, a burst of two requests without a deadline and three whose
1 us first-token deadline is already missed, under ``slo_shed="reject"``
(shed once the engine has measured a rate, as pass 1 left it); then
``engine.reset()`` on rank 0, which reaches the follower, and pass 3,
pass 1's requests again through the frontend alone, whose ``aclose``
stops the follower. Every rank records the requests it enqueued (rank
0's submissions, which the follower receives by broadcast). The CLI
runs at ``--tp 2`` with ``--arrival-rate`` (in this process) and with
``--http-port`` (a subprocess on a port the test found free, stopped by
SIGINT to its process group: every rank ignores it but rank 0, which
stops the follower; the CLI's ``--http-port 0`` means no server).

Tolerance: none. The SSE and blocking streams are tp=1's bitwise, the
shed requests are tp=1's, every rank's timeline (each enqueued request's
tokens, shed and done flags, in order) is rank 0's, and pass 3's streams
are pass 1's.
"""
import asyncio
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.launch.mesh import spawn_tp
from repro_torch.models import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.frontend import AsyncFrontend
from repro_torch.serve.http import ServeHTTP

POLICY = "A8d-C8-W4"
TIMEOUT_S = 120
ENG_KW = dict(policy=POLICY, slots=4, cache_len=96, max_new_cap=16,
              decode_block=4, prefill_bucket=16, kv_layout="dense",
              weights_layout="w4a8", slo_shed="reject")
# (prompt length, sampling) of pass 1's SSE streams, then its blocking
# completion's prompt length
SSE = ((9, {}), (14, {"temperature": 0.7, "top_k": 5, "seed": 3}),
       (21, {}), (9, {"temperature": 0.9, "seed": 8}))
BLOCKING = 17
MAX_TOKENS = 6
# the HTTP CLI's process-group timeout, and how long its server then
# stays idle before its first request: the follower waits in a
# collective the whole time, kept alive by rank 0's heartbeats
HTTP_PG_TIMEOUT_S, HTTP_IDLE_S = 8, 11
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Recording(ServeEngine):
    """An engine that lists every request submitted to it, in order (a
    follower lists its copies of rank 0's, which ``follow`` returns)."""

    def __init__(self, *a, **kw):
        self.seen = []
        super().__init__(*a, **kw)

    def submit(self, req):
        super().submit(req)
        self.seen.append(req)


def _prompts(cfg):
    r = np.random.default_rng(5)
    return [r.integers(1, cfg.vocab_size, n).tolist()
            for n in [n for n, _ in SSE] + [BLOCKING]]


async def _sse_completion(port, payload):
    """Minimal SSE client: the token ids of every data chunk."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(dict(payload, stream=True)).encode()
    writer.write(b"POST /v1/completions HTTP/1.1\r\n"
                 b"Content-Length: %d\r\n\r\n" % len(body) + body)
    await writer.drain()
    assert (await reader.readline()).split()[1] == b"200"
    while (await reader.readline()) not in (b"\r\n", b"\n"):
        pass
    toks = []
    async for raw in reader:
        line = raw.decode().strip()
        if line == "data: [DONE]":
            break
        if line.startswith("data: "):
            toks += json.loads(line[6:])["choices"][0]["token_ids"]
    writer.close()
    await writer.wait_closed()
    return toks


async def _blocking_completion(port, payload):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode()
    writer.write(b"POST /v1/completions HTTP/1.1\r\n"
                 b"Content-Length: %d\r\n\r\n" % len(body) + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, data = raw.partition(b"\r\n\r\n")
    assert head.split()[1] == b"200", head
    return json.loads(data)["choices"][0]["token_ids"]


async def _session(eng, prompts):
    out = {}
    async with AsyncFrontend(eng, stop_followers=False) as fe:
        async with ServeHTTP(fe, port=0) as srv:
            tasks = []
            for p, (_, kw) in zip(prompts, SSE):
                tasks.append(asyncio.create_task(_sse_completion(
                    srv.port, dict(kw, prompt=p, max_tokens=MAX_TOKENS))))
                await asyncio.sleep(0)      # the submissions' order
            blocking = await _blocking_completion(
                srv.port, {"prompt": prompts[-1], "max_tokens": MAX_TOKENS})
            out["sse"] = [await t for t in tasks]
            out["blocking"] = blocking
        # pass 2: a burst on the same engine, its rates measured
        handles = [await fe.submit(p, max_new_tokens=MAX_TOKENS,
                                   deadline_ms=None if i < 2 else 1e-3)
                   for i, p in enumerate(prompts)]
        for h in handles:
            await h.tokens()
        out["burst_shed"] = [h.shed for h in handles]
    eng.reset()
    async with AsyncFrontend(eng) as fe:
        handles = [await fe.submit(p, max_new_tokens=MAX_TOKENS, **kw)
                   for p, (_, kw) in zip(prompts, SSE)]
        out["after_reset"] = [await h.tokens() for h in handles]
    return out


def _engine(mesh):
    cfg = get_reduced_config("qwen2.5-3b")
    eng = _Recording(cfg, init_params(cfg, seed=0, device="cpu"),
                     mesh=mesh, device="cpu", **ENG_KW)
    return cfg, eng


def _timeline(eng):
    return [(len(r.prompt), tuple(r.generated), r.shed, r.done)
            for r in eng.seen]


def rank_session(mesh):
    """The session on this rank: rank 0 runs it, a follower follows; rank
    0 returns its results and every rank's timeline."""
    import torch.distributed as dist
    cfg, eng = _engine(mesh)
    out = {}
    if mesh.rank == 0:
        out = asyncio.run(_session(eng, _prompts(cfg)))
    else:
        eng.seen = eng.follow()
        # follow returns only at rank 0's stop
        out["followed_to_the_stop"] = True
    lines = [None] * dist.get_world_size()
    dist.all_gather_object(lines, (_timeline(eng), out.get(
        "followed_to_the_stop")))
    out["timelines"] = lines
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    cfg, eng = _engine(None)
    out = asyncio.run(_session(eng, _prompts(cfg)))
    out["timeline"] = _timeline(eng)
    return out


@pytest.fixture(scope="module")
def tp2():
    return spawn_tp(rank_session, 2, device="cpu", backend="gloo",
                    timeout_s=TIMEOUT_S)


class TestFrontendOnRankZero:
    def test_sse_and_blocking_streams_bitwise(self, base, tp2):
        """Pass 1 through HTTP at tp=2: every SSE stream and the blocking
        completion are tp=1's, greedy and sampled."""
        assert tp2["sse"] == base["sse"]
        assert tp2["blocking"] == base["blocking"]
        assert all(len(t) == MAX_TOKENS for t in base["sse"])
        assert len({tuple(t) for t in base["sse"]}) > 1

    def test_burst_sheds_as_tp1(self, base, tp2):
        """Pass 2: the three late requests are shed, the two without a
        deadline served, as at tp=1."""
        assert base["burst_shed"] == [False, False, True, True, True]
        assert tp2["burst_shed"] == base["burst_shed"]

    def test_ranks_agree_and_follower_stops(self, base, tp2):
        """Every rank enqueued the same requests in the same order and
        gave each the same tokens, shed and done flags; the follower's
        loop ended at rank 0's stop (pass 3's frontend closing), after
        the reset reached it; the timeline is tp=1's."""
        (t0, _), (t1, stopped) = tp2["timelines"]
        assert t0 == t1 and stopped
        assert t0 == base["timeline"]
        assert len(t0) == 2 * len(SSE) + 1 + len(SSE) + 1

    def test_reset_keeps_the_ranks_in_step(self, base, tp2):
        """Pass 3, after ``engine.reset()`` on rank 0: pass 1's streams
        again on both meshes."""
        assert tp2["after_reset"] == base["sse"] == base["after_reset"]


def test_follow_and_frontend_refuse_the_wrong_rank():
    """``follow`` runs on ranks > 0 of a mesh only; a frontend on a rank
    > 0 is refused."""
    cfg = get_reduced_config("qwen2.5-3b")
    eng = ServeEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                      device="cpu", **ENG_KW)
    with pytest.raises(RuntimeError, match="ranks > 0"):
        eng.follow()
    eng.stop_followers()                # off a mesh: nothing to stop

    class _Rank1:
        rank = 1

    eng._comm = _Rank1()
    with pytest.raises(RuntimeError, match="rank 0"):
        AsyncFrontend(eng)


def test_cli_tp2_open_loop():
    """``--tp 2 --arrival-rate``: rank 0's open loop (a warm-up pass, a
    reset, the timed pass) serves every request; the follower follows
    both passes and the reset."""
    from repro_torch.launch import serve
    stats = serve.main(["--tp", "2", "--tp-backend", "gloo", "--device",
                        "cpu", "--weights", "w4a8", "--arrival-rate", "50",
                        "--requests", "4", "--max-new", "4",
                        "--tp-timeout", str(TIMEOUT_S)])
    assert stats["tp_degree"] == 2 and stats["requests_finished"] == 4
    assert stats["client_ttft_n"] == 4
    assert stats["collectives"]["broadcast"] > 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_tp2_http_until_sigint():
    """``--tp 2 --http-port P``: rank 0 serves HTTP on P; idle for longer
    than the process group's timeout (``--tp-timeout``), it still
    answers a blocking completion (the follower was kept alive by rank
    0's heartbeats, and the server has no deadline); Ctrl-C to the whole
    process group stops rank 0's server, rank 0 stops the follower, and
    the command exits 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--tp", "2",
         "--tp-backend", "gloo", "--device", "cpu", "--weights", "w4a8",
         "--http-port", str(_free_port()),
         "--tp-timeout", str(HTTP_PG_TIMEOUT_S)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT, start_new_session=True)
    lines = []
    try:
        deadline = time.monotonic() + TIMEOUT_S
        port = None
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving on http://"):
                port = int(line.split()[2].rsplit(":", 1)[1])
        assert port is not None, "".join(lines)
        time.sleep(HTTP_IDLE_S)
        assert proc.poll() is None, "".join(lines)
        toks = asyncio.run(_blocking_completion(
            port, {"prompt": [5, 6, 7, 8], "max_tokens": 3}))
        assert len(toks) == 3
        os.killpg(proc.pid, signal.SIGINT)
        rest, _ = proc.communicate(timeout=60)
        lines.append(rest)
        assert proc.returncode == 0, "".join(lines)
        assert "shutting down" in rest
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
