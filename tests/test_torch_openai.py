"""The port's streaming channel, OpenAI payload mapping and trace context
(tony_tpu_torch.api, tony_tpu_torch.observability) against the JAX
package's (tony_tpu.api, tony_tpu.observability), mirroring the unit half
of tests/test_streaming.py: the same feed, finish and fail sequences give
the same take() sequence; both codecs, both parsers and the response and
chunk builders agree (``created`` removed); the pinned request, response
and finish_reason surface is the JAX package's, which stands in for its
docs lint; TraceContext parses the same headers."""

import io
import json

import pytest

from tony_tpu import observability as jO
from tony_tpu.api import openai as jA
from tony_tpu.api import stream as jS
from tony_tpu_torch import observability as O
from tony_tpu_torch.api import openai as A
from tony_tpu_torch.api import stream as S

# scripted producer sequences: ("feed", emitted) / ("finish", reason) /
# ("fail", message), then the consumer takes until the terminal
STREAM_SCRIPTS = {
    # absolute feeds: a replay's re-sent prefix is delivered once
    "absolute_feed": (64, [("feed", [1, 2, 3]), ("feed", [1, 2, 3]),
                           ("feed", [1, 2, 3, 4, 5]), ("finish", "length")]),
    # a consumer that does not drain: the chunk queue stays at 2 and the
    # rest coalesces into the newest chunk, never dropped
    "backpressure": (2, [("feed", list(range(i + 1))) for i in range(10)]
                     + [("finish", "stop")]),
    # the first terminal wins: a finish after a fail stays failed
    "fail_then_finish": (64, [("feed", [7]), ("fail", "boom"),
                              ("finish", "length")]),
    "finish_then_fail": (64, [("feed", [7, 8]), ("finish", "cancelled"),
                              ("fail", "late")]),
    "empty_then_done": (64, [("feed", []), ("finish", "expired")]),
}


def _run_script(mod, max_chunks, script):
    ts = mod.TokenStream(max_chunks=max_chunks)
    fed = []
    for op, arg in script:
        if op == "feed":
            fed.append(ts.feed(arg))
        else:
            getattr(ts, op)(arg)
    takes = []
    while True:
        kind, payload = ts.take(timeout=0.01)
        takes.append((kind, payload))
        if kind in ("done", "error"):
            break
    return fed, takes, ts.stalls, ts.n_fed, ts.finish_reason, ts.error


@pytest.mark.parametrize("name", sorted(STREAM_SCRIPTS))
def test_token_stream_matches_jax(name):
    max_chunks, script = STREAM_SCRIPTS[name]
    got = _run_script(S, max_chunks, script)
    assert got == _run_script(jS, max_chunks, script)
    if name == "backpressure":
        assert got[2] == 8 and got[1][:2] == [
            ("tokens", [0]), ("tokens", list(range(1, 10)))]


def test_token_stream_wait_beat_and_drain_all():
    for mod in (S, jS):
        ts = mod.TokenStream()
        assert ts.take(timeout=0.01) == ("wait", None)
        ts.feed([4, 5])
        ts.finish("stop")
        assert ts.drain_all(timeout=5) == ([4, 5], "stop", None)
        ts = mod.TokenStream()
        ts.feed([1])
        ts.fail("gone")
        assert ts.drain_all(timeout=5) == ([1], None, "gone")


class _Handler:
    """The parts of a BaseHTTPRequestHandler the SSE helpers touch."""

    def __init__(self, body: bytes = b""):
        self.headers = {"Content-Length": str(len(body))}
        self.rfile = io.BytesIO(body)
        self.sent = []

    def send_response(self, code):
        self.sent.append(("status", code))

    def send_header(self, k, v):
        self.sent.append((k, v))

    def end_headers(self):
        self.sent.append(("end",))


@pytest.mark.parametrize("value", [
    None, "", "3:7", "3:-2", " 4:5", "x:1", "3", "3:4:5", 12, "9:0"])
def test_sse_helpers_match_jax(value):
    assert S.parse_last_event_id(value) == jS.parse_last_event_id(value)
    obj = {"tokens": [1, 2], "v": value}
    for eid in (None, f"{value}:1"):
        assert S.sse_frame(obj, eid) == jS.sse_frame(obj, eid)
    assert S.sse_frame("[DONE]") == jS.sse_frame("[DONE]")
    assert (S.SSE_HEADERS, S.SSE_DONE) == (jS.SSE_HEADERS, jS.SSE_DONE)


@pytest.mark.parametrize("payload,path", [
    ({}, "/generate"), ({"stream": True}, "/generate"),
    ({"stream": False}, "/generate?stream=true"),
    ({}, "/generate?stream=1"), ({}, "/generate?stream=no"),
    ({"stream": "yes"}, "/generate"), ({"stream": 1}, "/generate")])
def test_stream_requested_matches_jax(payload, path):
    outs = []
    for mod in (S, jS):
        try:
            outs.append(mod.stream_requested(payload, path))
        except ValueError as e:
            outs.append(("ValueError", str(e)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("body", [b'{"prompt": [1]}', b"", b"[1, 2]",
                                  b"not json"])
def test_read_json_body_and_begin_sse_match_jax(body):
    outs = []
    for mod in (S, jS):
        try:
            outs.append(mod.read_json_body(_Handler(body)))
        except ValueError as e:
            outs.append(type(e).__name__)
    assert outs[0] == outs[1]
    heads = []
    for mod in (S, jS):
        h = _Handler()
        mod.begin_sse(h)
        heads.append(h.sent)
    assert heads[0] == heads[1] and ("status", 200) in heads[0]


CODEC_CASES = [
    ("ids", 256, "17 4 99"), ("ids", 256, "  5\t6 "), ("ids", 256, ""),
    ("ids", 256, "hello world"), ("bytes", 256, "hi"),
    ("bytes", 256, "hé中"), ("bytes", 128, "x"), ("bytes", 0, "x"),
]


@pytest.mark.parametrize("mode,vocab,text", CODEC_CASES)
def test_codec_matches_jax(mode, vocab, text):
    outs = []
    for mod in (A, jA):
        codec = mod.TokenCodec(mode, vocab_size=vocab)
        try:
            enc = codec.encode(text)
        except ValueError as e:
            enc = ("ValueError", str(e))
        outs.append((enc, codec.decode([104, 105, 300, 0xc3, 7]),
                     codec.decode([])))
    assert outs[0] == outs[1]
    for mod in (A, jA):
        with pytest.raises(ValueError, match="unknown text codec"):
            mod.TokenCodec("words")


def _parse_both(fn_name, payload, mode="ids"):
    outs = []
    for mod in (A, jA):
        try:
            outs.append(getattr(mod, fn_name)(
                payload, mod.TokenCodec(mode, vocab_size=256)))
        except (ValueError, TypeError) as e:
            outs.append((type(e).__name__, str(e)))
    return outs


COMPLETION_PAYLOADS = [
    {"prompt": [1, 2, 3], "max_tokens": 9, "temperature": 0.5, "top_k": 4,
     "stream": True, "model": "m"},
    {"prompt": "5 6"}, {"prompt": [1.0, 2]}, {"prompt": [1], "n": 1},
    {"prompt": [1], "stop": "7 8"}, {"prompt": [1], "stop": ["7", [9, 9]]},
    {"prompt": [1], "logprobs": 3}, {"prompt": [1], "logprobs": None},
    {"prompt": [1], "priority": "batch", "timeout_s": 5},
    {"prompt": [1], "extra": "ignored"},
    # malformed: the same error from both
    {"prompt": []}, {"prompt": 7}, {"prompt": [True]}, {},
    {"prompt": [1], "n": 2}, {"prompt": [1], "stream": "yes"},
    {"prompt": [1], "timeout_s": 0}, {"prompt": [1], "timeout_s": "inf"},
    {"prompt": [1], "model": 3}, {"prompt": [1], "priority": "x"},
    {"prompt": [1], "stop": []}, {"prompt": [1], "stop": [""]},
    {"prompt": [1], "stop": [[1, "a"]]}, {"prompt": [1], "stop": 5},
    {"prompt": [1], "logprobs": True}, {"prompt": [1], "logprobs": -1},
    {"prompt": [1], "logprobs": 2, "stream": True},
    {"prompt": "a b"}, {"prompt": [1], "max_tokens": "x"},
]


@pytest.mark.parametrize("i", range(len(COMPLETION_PAYLOADS)))
def test_parse_completion_request_matches_jax(i):
    port, ref = _parse_both("parse_completion_request",
                            COMPLETION_PAYLOADS[i])
    assert port == ref


CHAT_PAYLOADS = [
    {"messages": [{"role": "system", "content": "1 2"},
                  {"role": "user", "content": "3"}]},
    {"messages": [{"content": "4"}], "logprobs": True},
    {"messages": [{"content": "4"}], "logprobs": True, "top_logprobs": 3},
    {"messages": [{"content": "4"}], "logprobs": False, "top_logprobs": 3},
    {"messages": [{"content": "4"}], "stop": "9", "stream": True},
    {"messages": []}, {"messages": "hi"}, {"messages": [{"role": "user"}]},
    {"messages": [{"content": ""}]}, {"messages": [{"content": "4"}],
                                      "logprobs": 1},
    {"messages": [{"content": "4"}], "top_logprobs": -2},
    {"messages": [{"content": "4"}], "logprobs": True, "stream": True},
]


@pytest.mark.parametrize("i", range(len(CHAT_PAYLOADS)))
def test_parse_chat_request_matches_jax(i):
    port, ref = _parse_both("parse_chat_request", CHAT_PAYLOADS[i])
    assert port == ref


def _no_created(obj):
    obj = dict(obj)
    obj.pop("created", None)
    return obj


LOGPROBS = [{"token": 9, "logprob": -0.25, "top": [[9, 3], [-0.25, -2.0]]},
            {"token": 8, "logprob": None, "top": None}]


@pytest.mark.parametrize("reason", sorted(jA.FINISH_REASON_MAP) + ["odd"])
@pytest.mark.parametrize("mode", ["ids", "bytes"])
def test_response_and_chunk_dicts_match_jax(reason, mode):
    c, jc = A.TokenCodec(mode, 256), jA.TokenCodec(mode, 256)
    for lp in (None, LOGPROBS):
        for name in ("completion_response", "chat_response"):
            got = getattr(A, name)(3, "m", [9, 8], reason, 5, c, logprobs=lp)
            want = getattr(jA, name)(3, "m", [9, 8], reason, 5, jc,
                                     logprobs=lp)
            assert _no_created(got) == _no_created(want)
            assert set(got["choices"][0]) == (
                A.CHOICE_KEYS if name == "completion_response"
                else A.CHAT_CHOICE_KEYS)
    for fin in (None, reason):
        assert _no_created(A.completion_chunk(1, "m", [4], c, fin)) == \
            _no_created(jA.completion_chunk(1, "m", [4], jc, fin))
        for first in (True, False):
            assert _no_created(A.chat_chunk(1, "m", [4], c, fin, first)) \
                == _no_created(jA.chat_chunk(1, "m", [4], jc, fin, first))


def _frames(blob: bytes) -> list:
    """SSE bytes -> [(id or None, data)] with ``created`` removed."""
    out = []
    for block in blob.decode().split("\n\n"):
        if not block:
            continue
        eid, data = None, None
        for line in block.split("\n"):
            if line.startswith("id: "):
                eid = line[4:]
            elif line.startswith("data: "):
                data = line[6:]
        out.append((eid, data if data == "[DONE]"
                    else _no_created(json.loads(data))))
    return out


@pytest.mark.parametrize("chat", [False, True])
@pytest.mark.parametrize("skip", [0, 3, 9])
def test_stream_frame_fns_match_jax(chat, skip):
    """Deltas, the closing chunk with trace_id, the error envelope, the
    withheld acked tokens of a resumed stream and the collected tokens."""
    outs = []
    for mod in (A, jA):
        got: list = []
        frame, final, err = mod.stream_frame_fns(
            7, "m", mod.TokenCodec("ids"), chat, skip=skip, collect=got,
            trace_id="abcdef0123456789")
        blob = b"".join(frame(t) for t in ([1, 2], [3, 4, 5], [6]))
        blob += final("length") + err("boom")
        outs.append((_frames(blob), got))
    assert outs[0] == outs[1]
    assert outs[0][1] == [1, 2, 3, 4, 5, 6]


def test_pinned_surface_matches_jax():
    for name in ("COMPLETION_REQUEST_PARAMS", "CHAT_REQUEST_PARAMS",
                 "COMPLETION_RESPONSE_KEYS", "CHAT_RESPONSE_KEYS",
                 "CHOICE_KEYS", "CHAT_CHOICE_KEYS", "USAGE_KEYS",
                 "FINISH_REASON_MAP"):
        assert getattr(A, name) == getattr(jA, name), name
    assert set(A.__all__) == set(jA.__all__)
    assert (O.TRACE_HEADER, O.TRACE_ID_RESPONSE_HEADER) == (
        jO.TRACE_HEADER, jO.TRACE_ID_RESPONSE_HEADER)


@pytest.mark.parametrize("header", [
    "0123456789abcdef:fedcba9876543210", "deadbeef:cafebabe",
    " 0123456789abcdef:0123456789abcdef ", None, "", "nocolon",
    "0123456789ABCDEF:fedcba9876543210", "0123:4567", "g123456789:12345678",
    "0123456789abcdef:", ":0123456789abcdef",
    "0123456789abcdef0123456789abcdef0:01234567"])
def test_trace_context_from_header_matches_jax(header):
    got, want = (O.TraceContext.from_header(header),
                 jO.TraceContext.from_header(header))
    assert (got is None) == (want is None)
    if got is None:
        return
    # the sender's trace and span adopted; a fresh span of our own
    assert (got.trace_id, got.parent_span_id) == (want.trace_id,
                                                  want.parent_span_id)
    assert len(got.span_id) == 16 and got.span_id != want.span_id
    assert got.to_header() == f"{got.trace_id}:{got.span_id}"
    child = got.child()
    assert (child.trace_id, child.parent_span_id) == (got.trace_id,
                                                      got.span_id)
    # as_dict round-trips through either framework's from_dict
    d = got.as_dict()
    assert O.TraceContext.from_dict(d).as_dict() == d
    assert jO.TraceContext.from_dict(d).as_dict() == d


def test_trace_context_roots_and_dicts_match_jax():
    assert O.TraceContext.for_request_id("req-1").trace_id == \
        jO.TraceContext.for_request_id("req-1").trace_id
    root = O.TraceContext.mint()
    assert root.parent_span_id is None and len(root.trace_id) == 16
    assert O.TraceContext.from_header(root.to_header()).parent_span_id == \
        root.span_id
    for d in (None, {}, {"trace_id": 1, "span_id": "a"}, [1],
              {"trace_id": "a", "span_id": "b", "parent_span_id": 3},
              {"trace_id": "a", "span_id": "b", "parent_span_id": "c"}):
        got, want = O.TraceContext.from_dict(d), jO.TraceContext.from_dict(d)
        assert (got and got.as_dict()) == (want and want.as_dict())
