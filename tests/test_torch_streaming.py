"""The port's streaming serving (tony_tpu_torch.cli.serve's SSE and /v1
routes over ``SlotServer``'s token streams) on the CPU, mirroring the HTTP
half of tests/test_streaming.py.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``
(TINY widths, float32); prompts come from numpy. Streamed /generate,
streamed and buffered /v1/completions and /v1/chat/completions are held
against the JAX package's SlotServer's greedy completions of the same
prompts (token-identical: the seeds are away from near-ties of the greedy
logits), and the /v1 bodies against the JAX package's response builders
on those tokens. The rest mirrors the reference's streaming tests: stop
sequences, streamed logprobs refused, a stream across a loop crash, replay
off, a mid-stream disconnect, the Last-Event-ID reconnect, --text-codec
and the trace header."""

import dataclasses
import json
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tony_tpu.api import openai as jA
from tony_tpu.events import journal as jJ
from tony_tpu.models import transformer as jT
from tony_tpu.models.serving import Request as JRequest
from tony_tpu.models.serving import SlotServer as JSlotServer
from tony_tpu_torch.api import openai as A
from tony_tpu_torch.api.stream import TokenStream
from tony_tpu_torch.cli import serve
from tony_tpu_torch.cli.serve import ServeApp
from tony_tpu_torch.events import journal as J
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.observability import TraceContext

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=jnp.float32)
SRV = dict(slots=2, max_len=64, block_size=4, prefill_chunk=8)
# (numpy seed, prompt length, new tokens) of the prompts the tests post
PROMPTS = {"a": (31, 6, 12), "b": (37, 6, 10), "c": (43, 6, 16),
           "d": (53, 6, 16), "e": (33, 6, 40)}
TRACE = "0123456789abcdef:fedcba9876543210"


def _prompt(key):
    seed, n, _ = PROMPTS[key]
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], n).tolist()


@pytest.fixture(scope="module")
def model():
    jcfg = jT.TransformerConfig(**TINY)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def ref(model):
    """key -> the JAX SlotServer's greedy completion of that prompt (its
    whole budget), plus "bytes": the prompt "hi!" as UTF-8 bytes."""
    jcfg, _, tree, _ = model
    jsrv = JSlotServer(tree, jcfg, **SRV)
    prompts = {k: (_prompt(k), PROMPTS[k][2]) for k in PROMPTS}
    prompts["bytes"] = ([104, 105, 33], 8)
    reqs = {k: JRequest(prompt=np.asarray(p, np.int32), max_new_tokens=n)
            for k, (p, n) in prompts.items()}
    for r in reqs.values():
        jsrv.submit(r)
    done = jsrv.run_until_drained()
    return {k: done[r.id].tokens for k, r in reqs.items()}


def _server(model, **kw):
    _, cfg, _, params = model
    return S.SlotServer(params, cfg, device="cpu", **{**SRV, **kw})


class _Http:
    """A ServeApp's handler on an ephemeral port, in a thread."""

    def __init__(self, app, codec=None):
        self.app = app
        self.httpd = serve.make_httpd(app, "127.0.0.1", 0, codec)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def post(self, path, payload, headers=None):
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read()), r.headers
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), e.headers

    def sse(self, path, payload, headers=None):
        """POST expecting SSE -> [(id line or None, data)], data parsed
        from JSON except the [DONE] sentinel."""
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        frames, eid = [], None
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            for raw in r:
                line = raw.decode().strip()
                if line.startswith("id: "):
                    eid = line[4:]
                elif line.startswith("data: "):
                    data = line[6:]
                    frames.append((eid, data if data == "[DONE]"
                                   else json.loads(data)))
                    eid = None
        return frames

    def first_frame_then_close(self, path, payload):
        """A raw client that reads the first SSE frame and hangs up ->
        (its id line, its data, the instant of the close)."""
        sock = socket.create_connection(("127.0.0.1", self.port), timeout=60)
        body = json.dumps(payload).encode()
        sock.sendall(f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: "
                     f"{len(body)}\r\n\r\n".encode() + body)
        buf = b""
        while b"data: " not in buf or not buf.endswith(b"\n\n"):
            chunk = sock.recv(65536)
            assert chunk, "the server closed before a frame"
            buf += chunk
        sock.close()
        closed = time.monotonic()
        frame = buf.split(b"\r\n\r\n", 1)[1].decode().split("\n\n")[0]
        lines = dict(x.split(": ", 1) for x in frame.split("\n"))
        return lines["id"], json.loads(lines["data"]), closed

    def stats(self):
        with urllib.request.urlopen(self.url + "/stats", timeout=30) as r:
            return json.loads(r.read())

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _tokens(frames):
    """The concatenated deltas of a /generate stream."""
    return [t for _, f in frames if "tokens" in f for t in f["tokens"]]


def _cursors(frames):
    return [int(eid.split(":")[1]) for eid, _ in frames if eid]


def _wait(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


@pytest.fixture
def http(model):
    apps = []

    def make(codec=None, app_kw=None, **srv_kw):
        app = ServeApp(_server(model, **srv_kw), **(app_kw or {}))
        app.start()
        h = _Http(app, codec)
        apps.append(h)
        return h

    yield make
    for h in apps:
        h.close()
        h.app.shutdown()


def test_generate_sse_matches_jax_and_buffered(http, ref):
    """/generate?stream=true: the deltas, over at least two frames with
    strictly increasing cursors, are the JAX SlotServer's tokens; the
    closing frame carries the finish_reason, the count and the trace id;
    the buffered POST agrees; /stats counts the stream."""
    h = http(app_kw=dict(journal_checkpoint_s=0.01))
    frames = h.sse("/generate?stream=true",
                   {"prompt": _prompt("a"), "max_new_tokens": 12})
    *deltas, (eid, final) = frames
    assert len(deltas) >= 2, "delivery must be incremental"
    assert _tokens(deltas) == ref["a"]
    cur = _cursors(frames)
    assert cur[:-1] == sorted(set(cur[:-1])) and cur[-1] == 12
    assert eid == f"{final['id']}:12"
    assert final["finish_reason"] == "length" and final["n_tokens"] == 12
    assert len(final["trace_id"]) == 16
    # the payload's "stream": true is the same opt-in
    frames = h.sse("/generate", {"prompt": _prompt("a"),
                                 "max_new_tokens": 12, "stream": True})
    assert _tokens(frames) == ref["a"]
    code, body, _ = h.post("/generate", {"prompt": _prompt("a"),
                                         "max_new_tokens": 12})
    assert code == 200 and body["tokens"] == ref["a"]
    st = h.stats()
    assert (st["streams_opened"], st["streams_active"], st["stream_stalls"],
            st["stream_disconnects"]) == (2, 0, 0, 0)


def test_openai_routes_match_jax(http, ref):
    """/v1/completions and /v1/chat/completions, buffered and streamed:
    the JAX SlotServer's tokens in the JAX package's response shapes
    (``created`` aside), [DONE] at the end of a stream, the assistant role
    in the first chat delta, the trace id echoed, and the OpenAI error
    envelope for a malformed body or an unknown model."""
    h = http()
    prompt, want = _prompt("b"), ref["b"]
    text = " ".join(map(str, prompt))
    codec = jA.TokenCodec("ids")

    def no_created(obj):
        return {k: v for k, v in obj.items() if k != "created"}

    code, body, hdr = h.post("/v1/completions",
                             {"prompt": prompt, "max_tokens": 10},
                             headers={"X-Tony-Trace": TRACE})
    assert code == 200 and hdr["X-Tony-Trace-Id"] == TRACE.split(":")[0]
    rid = int(body["id"].split("-")[1])
    assert no_created(body) == no_created(jA.completion_response(
        rid, "default", want, "length", len(prompt), codec))
    code, body, _ = h.post("/v1/chat/completions", {
        "messages": [{"role": "user", "content": text}], "max_tokens": 10,
        "model": "default"})
    rid = int(body["id"].split("-")[1])
    assert code == 200 and no_created(body) == no_created(jA.chat_response(
        rid, "default", want, "length", len(prompt), codec))
    for chat in (False, True):
        payload = ({"messages": [{"role": "user", "content": text}]}
                   if chat else {"prompt": text})
        frames = h.sse("/v1/chat/completions" if chat else "/v1/completions",
                       {**payload, "max_tokens": 10, "stream": True},
                       headers={"X-Tony-Trace": TRACE})
        assert frames[-1] == (None, "[DONE]")
        chunks = [f["choices"][0] for _, f in frames[:-1]]
        assert [t for c in chunks for t in c["tokens"]] == want
        assert chunks[-1]["finish_reason"] == "length"
        assert all(c["finish_reason"] is None for c in chunks[:-1])
        assert frames[-2][1]["trace_id"] == TRACE.split(":")[0]
        if chat:
            assert chunks[0]["delta"]["role"] == "assistant"
            assert " ".join(c["delta"]["content"] for c in chunks[:-1]) \
                == codec.decode(want)
        else:
            assert " ".join(c["text"] for c in chunks[:-1]) == \
                codec.decode(want)
        assert _cursors(frames)[-1] == 10
    for path, bad in (("/v1/completions", {"prompt": []}),
                      ("/v1/completions", {"prompt": [1], "model": "m"}),
                      ("/v1/chat/completions", {"messages": []}),
                      ("/v1/completions", {"prompt": [1, 999]})):
        code, body, _ = h.post(path, bad)
        assert code == 400, bad
        assert body["error"]["type"] == "invalid_request_error"


def test_stop_sequences_buffered_and_streamed(http, ref):
    """A per-request stop sequence truncates the greedy stream at its
    earliest end, the same on a buffered POST, across SSE frames and on
    /v1 (text through the codec); the next stop-less request is whole."""
    h = http()
    prompt, full = _prompt("d"), ref["d"]
    seq = full[4:6]
    end = next(e for e in range(2, 17) if full[e - 2:e] == seq)
    code, body, _ = h.post("/generate", {"prompt": prompt,
                                         "max_new_tokens": 16, "stop": seq})
    assert (code, body["tokens"], body["finish_reason"]) == (
        200, full[:end], "stop")
    frames = h.sse("/generate?stream=true",
                   {"prompt": prompt, "max_new_tokens": 16, "stop": [seq]})
    assert _tokens(frames) == full[:end]
    assert frames[-1][1]["finish_reason"] == "stop"
    assert frames[-1][1]["n_tokens"] == end
    frames = h.sse("/v1/completions", {
        "prompt": prompt, "max_tokens": 16, "stream": True,
        "stop": " ".join(map(str, seq))})
    chunks = [f["choices"][0] for _, f in frames[:-1]]
    assert [t for c in chunks for t in c["tokens"]] == full[:end]
    assert chunks[-1]["finish_reason"] == "stop"
    code, body, _ = h.post("/generate", {"prompt": prompt,
                                         "max_new_tokens": 16})
    assert body["tokens"] == full and body["finish_reason"] == "length"
    for bad in ("x", [], [[]], [["a"]]):
        assert h.post("/generate", {"prompt": prompt, "stop": bad})[0] == 400


def test_streamed_logprobs_answer_400(http):
    """logprobs are for buffered responses only: a streamed request asking
    for them is a 400 on every route (the /v1 ones in the OpenAI
    envelope), and no stream is opened."""
    h = http()
    cases = (("/generate?stream=true", {"prompt": [1, 2], "logprobs": 2}),
             ("/generate", {"prompt": [1, 2], "logprobs": 1,
                            "stream": True}),
             ("/v1/completions", {"prompt": [1, 2], "logprobs": 1,
                                  "stream": True}),
             ("/v1/chat/completions", {"messages": [{"content": "1 2"}],
                                       "logprobs": True, "stream": True}))
    for path, payload in cases:
        code, body, _ = h.post(path, payload)
        assert code == 400, path
        err = body["error"]
        msg = err["message"] if isinstance(err, dict) else err
        assert "logprobs are unavailable on streamed requests" in msg
    assert h.stats()["streams_opened"] == 0
    code, body, _ = h.post("/v1/completions", {"prompt": [1, 2],
                                               "logprobs": 2,
                                               "max_tokens": 3})
    lp = body["choices"][0]["logprobs"]
    assert code == 200 and len(lp["token_logprobs"]) == 3


def test_stream_across_a_loop_crash_matches_crashless(http, ref, monkeypatch):
    """Replay under an open stream: a mid-decode loop crash replays the
    request from its journaled prefix while the SSE consumer reads; the
    stream delivers each token once (strictly increasing cursors, the
    count equal to the budget) and equals the crashless JAX stream."""
    monkeypatch.setenv("TONY_TEST_SERVING_CRASH_AT_BLOCKS", "2,5")
    h = http(app_kw=dict(max_loop_restarts=8, loop_backoff_s=0.02,
                         journal_checkpoint_s=0.01))
    srv = h.app.server
    frames = h.sse("/generate?stream=true",
                   {"prompt": _prompt("c"), "max_new_tokens": 16})
    assert frames[-1][1]["finish_reason"] == "length"
    assert _tokens(frames) == ref["c"]
    cur = _cursors(frames)
    assert cur[:-1] == sorted(set(cur[:-1])) and cur[-1] == 16
    assert srv.chaos_faults_injected == 2 and srv.replays >= 1
    assert h.app.health()["loop_restarts"] == 2


def test_stream_ends_in_an_error_frame(http, model, monkeypatch):
    """Every stream terminates: with replay off a loop crash ends the open
    stream in one in-band error frame; a spent restart budget fails every
    open stream, queued ones too; a drain fails the queued ones; a missed
    deadline cancels the request with an error frame."""
    monkeypatch.setenv("TONY_TEST_SERVING_CRASH_AT_BLOCKS", "1")
    h = http(replay=False, app_kw=dict(loop_backoff_s=0.02))
    frames = h.sse("/generate?stream=true", {"prompt": [5, 6, 7],
                                             "max_new_tokens": 16})
    assert "lost to a serving-loop failure" in frames[-1][1]["error"]
    frames = h.sse("/v1/completions", {"prompt": [5, 6], "max_tokens": 4,
                                       "stream": True})
    assert frames[-2][1]["choices"][0]["finish_reason"] == "length"
    # the budget spent (0 restarts): the admitted and the queued stream
    app = ServeApp(_server(model, slots=1), max_loop_restarts=0)
    streams = [TokenStream(), TokenStream()]
    for ts in streams:
        app.submit_async([1, 2, 3], 8, stream=ts)
    app.start()
    for ts in streams:
        toks, reason, err = ts.drain_all(timeout=60)
        assert reason is None and "serving loop failed" in err
    assert app.health()["status"] == "down"
    app.shutdown()
    monkeypatch.delenv("TONY_TEST_SERVING_CRASH_AT_BLOCKS")
    # a drain fails the queued stream
    srv = _server(model)
    srv.pause_admission = True
    app = ServeApp(srv)
    ts = TokenStream()
    app.submit_async([1, 2, 3], 8, stream=ts)
    app.start()
    app.shutdown(drain=True, drain_timeout_s=5)
    assert "shutting down" in ts.drain_all(timeout=10)[2]
    # the relay's deadline: slow turns, a 0.6 s budget
    monkeypatch.setenv("TONY_TEST_SERVING_STEP_DELAY_MS", "100")
    h = http()
    frames = h.sse("/generate?stream=true", {
        "prompt": [5, 6, 7], "max_new_tokens": 56, "timeout_s": 0.6})
    assert "timed out; cancelled" in frames[-1][1]["error"]
    assert _wait(lambda: h.stats()["active"] == 0)
    assert h.stats()["cancelled"] == 1


def test_disconnect_cancels_and_reconnect_resumes(http, ref, monkeypatch):
    """A client that hangs up after the first frame: its request is
    cancelled and the disconnect counted, within a wait beat and a block;
    a re-POST with ``Last-Event-ID: <rid>:<n>`` resumes from the parked
    prefix, and the two parts are the JAX stream with no token twice and
    none missing; the prefix is single use; a malformed header is a fresh
    request."""
    monkeypatch.setenv("TONY_TEST_SERVING_STEP_DELAY_MS", "30")
    h = http(app_kw=dict(journal_checkpoint_s=0.01))
    prompt, want = _prompt("e"), ref["e"]
    payload = {"prompt": prompt, "max_new_tokens": 40}
    eid, data, closed = h.first_frame_then_close("/generate?stream=true",
                                                 payload)
    rid, n = map(int, eid.split(":"))
    assert 0 < n < 40 and data["tokens"] == want[:n]
    assert _wait(lambda: h.stats()["stream_disconnects"] == 1, timeout=10)
    assert time.monotonic() - closed < 2.0
    assert _wait(lambda: h.stats()["active"] == 0, timeout=10)
    st = h.stats()
    assert st["cancelled"] == 1 and st["streams_active"] == 0
    frames = h.sse("/generate?stream=true", payload,
                   headers={"Last-Event-ID": eid})
    assert data["tokens"] + _tokens(frames) == want
    cur = _cursors(frames)
    assert cur[0] - len(frames[0][1]["tokens"]) == n and cur[-1] == 40
    assert frames[-1][1]["n_tokens"] == 40 - n
    assert h.app.resume_prefix(rid) is None         # popped
    assert h.stats()["replays"] == 1
    frames = h.sse("/generate?stream=true", payload,
                   headers={"Last-Event-ID": "not-a-cursor"})
    assert _tokens(frames) == want
    # /v1 parks and resumes the same way
    eid, data, _ = h.first_frame_then_close(
        "/v1/completions", {"prompt": prompt, "max_tokens": 40,
                            "stream": True})
    n = int(eid.split(":")[1])
    assert _wait(lambda: h.stats()["stream_disconnects"] == 2, timeout=10)
    frames = h.sse("/v1/completions", {"prompt": prompt, "max_tokens": 40,
                                       "stream": True},
                   headers={"Last-Event-ID": eid})
    got = data["choices"][0]["tokens"] + [
        t for _, f in frames[:-1] for t in f["choices"][0]["tokens"]]
    assert got == want and n == len(data["choices"][0]["tokens"])


def test_reconnect_to_a_live_request_cancels_the_zombie(http, ref,
                                                        monkeypatch):
    """A client that reconnects before the server saw its old connection
    die: the old request is cancelled (its stream ends "cancelled") and
    its journaled prefix resumed, so the parts are the JAX stream."""
    monkeypatch.setenv("TONY_TEST_SERVING_STEP_DELAY_MS", "30")
    h = http(app_kw=dict(journal_checkpoint_s=0.01))
    prompt, want = _prompt("e"), ref["e"]
    req = urllib.request.Request(
        h.url + "/generate?stream=true",
        data=json.dumps({"prompt": prompt, "max_new_tokens": 40}).encode())
    old = urllib.request.urlopen(req, timeout=60)
    eid = old.readline().decode().strip()[4:]
    first = json.loads(old.readline().decode()[6:])["tokens"]
    rid, n = map(int, eid.split(":"))
    frames = h.sse("/generate?stream=true",
                   {"prompt": prompt, "max_new_tokens": 40},
                   headers={"Last-Event-ID": eid})
    assert first + _tokens(frames) == want and n == len(first)
    rest = [json.loads(x.decode()[6:]) for x in old
            if x.startswith(b"data: ")]
    old.close()
    assert rest[-1]["finish_reason"] == "cancelled" and rest[-1]["id"] == rid
    assert h.stats()["cancelled"] >= 1


def test_text_codec_bytes(http, ref, monkeypatch):
    """--text-codec bytes: a text prompt is its UTF-8 bytes and the text
    of a completion its tokens as bytes (the JAX codec's decoding of the
    JAX SlotServer's tokens); under vocab 256 a text prompt is refused
    with 400, through serve's own main."""
    h = http(codec=A.TokenCodec("bytes", vocab_size=256))
    code, body, _ = h.post("/v1/completions", {"prompt": "hi!",
                                               "max_tokens": 8})
    want = ref["bytes"]
    assert code == 200 and body["choices"][0]["tokens"] == want
    assert body["choices"][0]["text"] == \
        jA.TokenCodec("bytes", 256).decode(want)
    assert body["usage"]["prompt_tokens"] == 3
    frames = h.sse("/v1/chat/completions", {
        "messages": [{"content": "hi"}, {"content": "!"}], "max_tokens": 8,
        "stream": True})
    assert [t for _, f in frames[:-1]
            for t in f["choices"][0]["tokens"]] == want
    # the CLI: --text-codec bytes at --vocab 64, driven through main()
    argv = ["--device", "cpu", "--port", "0", "--d-model", "32",
            "--n-layers", "1", "--n-heads", "2", "--d-ff", "64", "--vocab",
            "64", "--dtype", "float32", "--slots", "2", "--max-len", "32",
            "--block-size", "4", "--prefill-chunk", "8", "--text-codec",
            "bytes"]
    real, seen = serve.make_httpd, {}

    def spy(app, host, port, codec=None):
        httpd = real(app, host, port, codec)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"

        def drive():
            c = _Http.__new__(_Http)
            c.url = url
            seen["text"] = c.post("/v1/completions", {"prompt": "hi"})
            seen["ids"] = c.post("/v1/completions",
                                 {"prompt": [7, 8], "max_tokens": 3})
            httpd.shutdown()

        threading.Thread(target=drive, daemon=True).start()
        return httpd

    monkeypatch.setattr(serve, "make_httpd", spy)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                 signal.SIGTERM)}
    try:
        assert serve.main(argv) == 0
    finally:
        for s, f in handlers.items():
            signal.signal(s, f)
    code, body, _ = seen["text"]
    assert code == 400 and "vocab >= 256" in body["error"]["message"]
    code, body, _ = seen["ids"]
    toks = body["choices"][0]["tokens"]
    assert code == 200 and body["choices"][0]["text"] == bytes(toks).decode(
        "utf-8", errors="replace")


def test_trace_header_echoed_and_journaled(model, tmp_path):
    """X-Tony-Trace is adopted (the sender's span the parent, a fresh span
    ours), echoed as X-Tony-Trace-Id and on a stream's closing frame, and
    journaled as as_dict(); without the header a root is minted. The JAX
    package's RequestJournal recovers the port's file with the trace, and
    the port's recovery keeps it."""
    from tony_tpu_torch.events.journal import JOURNAL_FILE

    args = serve.build_argparser().parse_args(
        ["--device", "cpu", "--d-model", "64", "--n-layers", "2",
         "--n-heads", "4", "--d-ff", "128", "--vocab", "256", "--dtype",
         "float32", "--slots", "2", "--max-len", "64", "--block-size", "4",
         "--prefill-chunk", "8", "--trace-dir", str(tmp_path)])
    app = serve.build_app(args)
    app.start()
    h = _Http(app)
    path = tmp_path / JOURNAL_FILE
    try:
        code, body, hdr = h.post("/generate", {"prompt": [3, 4],
                                               "max_new_tokens": 3},
                                 headers={"X-Tony-Trace": TRACE})
        assert code == 200 and hdr["X-Tony-Trace-Id"] == TRACE[:16]
        code, body2, hdr2 = h.post("/generate", {"prompt": [3, 4],
                                                 "max_new_tokens": 3})
        minted = hdr2["X-Tony-Trace-Id"]
        assert len(minted) == 16 and minted != TRACE[:16]
        frames = h.sse("/generate?stream=true", {"prompt": [3, 4],
                                                 "max_new_tokens": 3},
                       headers={"X-Tony-Trace": TRACE})
        assert frames[-1][1]["trace_id"] == TRACE[:16]
        code, _, hdr = h.post("/generate", {"prompt": [3], "stream": "x"},
                              headers={"X-Tony-Trace": "garbled"})
        assert code == 400
    finally:
        h.close()
        app.shutdown()
    subs = {r["id"]: r["trace"] for r in map(json.loads,
                                             path.read_text().splitlines())
            if r["op"] == "submit"}
    t1, t2 = subs[body["id"]], subs[body2["id"]]
    assert (t1["trace_id"], t1["parent_span_id"]) == (TRACE[:16], TRACE[17:])
    assert len(t1["span_id"]) == 16 and t1["span_id"] != TRACE[17:]
    assert t2["trace_id"] == minted and t2["parent_span_id"] is None
    # an unfinished request's trace, recovered by both frameworks
    ctx = TraceContext.from_header(TRACE)
    srv = _server(model, journal=J.RequestJournal(tmp_path / "j.jsonl"))
    ServeApp(srv).submit_async([1, 2, 3], 8, trace=ctx)
    srv.shutdown()
    _, jentries = jJ.RequestJournal.recover(tmp_path / "j.jsonl")
    assert [e.trace for e in jentries] == [ctx.as_dict()]
    journal, entries = J.RequestJournal.recover(tmp_path / "j.jsonl")
    srv = _server(model, journal=journal)
    assert srv.recover_journal(entries) == 1
    (entry,) = [journal.get(r.id) for r in srv._queue]
    assert entry.trace == ctx.as_dict()
    srv.shutdown()


def test_engine_streams_match_completions_and_jax(model, ref):
    """The engine's hooks without HTTP: a request completed at submit (its
    resume prefix fills the budget) is delivered at attach; in EOS mode
    every processed block feeds the stream, and an undrained consumer's
    chunks coalesce (counted as stalls, no token lost); the streamed
    tokens are the completion's and the JAX SlotServer's."""
    srv = _server(model)
    ts = TokenStream()
    req = S.Request(prompt=[1, 2], max_new_tokens=3, resume_tokens=[4, 5, 6])
    srv.submit(req)
    srv.attach_stream(req.id, ts)
    assert ts.drain_all(timeout=5) == ([4, 5, 6], "length", None)
    assert srv.streams_active == 0 and srv.streams_opened == 1
    srv.drain_completed()
    # EOS mode with a stop token the stream never emits: a feed a block
    stop = next(t for t in range(256) if t not in ref["c"])
    srv = _server(model, stop_tokens=(stop,))
    ts = TokenStream(max_chunks=2)
    req = S.Request(prompt=_prompt("c"), max_new_tokens=16)
    srv.submit(req)
    srv.attach_stream(req.id, ts)
    assert srv.stats()["streams_active"] == 1
    done = srv.run_until_drained()
    toks, reason, _ = ts.drain_all(timeout=5)
    assert toks == done[req.id].tokens == ref["c"] and reason == "length"
    assert ts.stalls >= 1 and srv.stats()["stream_stalls"] == ts.stalls
    assert srv.stats()["streams_active"] == 0
