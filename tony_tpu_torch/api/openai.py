"""OpenAI-compatible payload mapping for ``/v1/completions`` and
``/v1/chat/completions`` (the port's own copy of the JAX package's
api/openai.py).

The serving stack is token-native (prompts and completions are token-id
sequences; no tokenizer ships with the repo), so the surface is defined
around that:

- ``/v1/completions`` accepts ``prompt`` as a token-id array or as TEXT
  run through the process's ``TokenCodec``;
- responses carry the standard ``choices[0].text`` (codec-decoded) and a
  non-standard ``choices[0].tokens`` with the raw ids: the identity of a
  streamed and a buffered response is stated over tokens.

``TokenCodec`` has two modes (serve ``--text-codec``):

- ``ids`` (default): text is space-separated decimal token ids
  ("17 4 99" <-> [17, 4, 99]), an exact round trip;
- ``bytes``: UTF-8 byte-level (needs vocab >= 256); ids >= 256 decode as
  U+FFFD, a lossy display and an exact encode.

The chat template is minimal: the messages' contents are codec-encoded
and concatenated in order (roles are not token-injected: there is no
tokenizer to own special tokens). The accepted request params, the
response keys and the finish_reason mapping below are pinned, and held
equal to the JAX package's by the tests.
"""

from __future__ import annotations

import time

from .stream import SSE_DONE, sse_frame

__all__ = [
    "TokenCodec", "parse_completion_request", "parse_chat_request",
    "completion_response", "chat_response", "completion_chunk",
    "chat_chunk", "stream_frame_fns",
    "COMPLETION_REQUEST_PARAMS", "CHAT_REQUEST_PARAMS",
    "COMPLETION_RESPONSE_KEYS", "CHAT_RESPONSE_KEYS", "CHOICE_KEYS",
    "CHAT_CHOICE_KEYS", "USAGE_KEYS", "FINISH_REASON_MAP",
]


# ---- the pinned surface ---------------------------------------------------

# request params the server HONORS (anything else in the payload is
# ignored, except the validated-if-present ones noted in the doc)
COMPLETION_REQUEST_PARAMS = frozenset((
    "model", "prompt", "max_tokens", "temperature", "top_k", "stream",
    "timeout_s", "stop", "logprobs", "priority",
))
CHAT_REQUEST_PARAMS = frozenset((
    "model", "messages", "max_tokens", "temperature", "top_k", "stream",
    "timeout_s", "stop", "logprobs", "top_logprobs", "priority",
))

COMPLETION_RESPONSE_KEYS = frozenset((
    "id", "object", "created", "model", "choices", "usage",
))
CHAT_RESPONSE_KEYS = COMPLETION_RESPONSE_KEYS
CHOICE_KEYS = frozenset(("index", "text", "tokens", "finish_reason",
                         "logprobs"))
CHAT_CHOICE_KEYS = frozenset(("index", "message", "tokens",
                              "finish_reason", "logprobs"))
USAGE_KEYS = frozenset(("prompt_tokens", "completion_tokens",
                        "total_tokens"))

# engine finish_reason (models/serving.py COMPLETION_FINISH_REASONS) ->
# the /v1 wire value. "stop"/"length" are the OpenAI vocabulary;
# "cancelled"/"expired"/"shed" pass through VERBATIM (non-standard,
# documented) — lying "stop" about a truncated stream would break any
# client that trusts the enum to mean "the model chose to end here".
# "shed" is the per-class admission-tier displacement terminal: a
# buffered waiter gets HTTP 429 + Retry-After instead of a body.
FINISH_REASON_MAP = {
    "stop": "stop",
    "length": "length",
    "cancelled": "cancelled",
    "expired": "expired",
    "shed": "shed",
    # a prefill-role replica's terminal (disaggregated roles, not
    # ported): zero tokens, the KV handoff carries the request onward
    "prefilled": "prefilled",
}


class TokenCodec:
    """text <-> token-id mapping for the /v1 surface (module
    docstring). ``mode`` is "ids" or "bytes"."""

    def __init__(self, mode: str = "ids", vocab_size: int = 0):
        if mode not in ("ids", "bytes"):
            raise ValueError(f"unknown text codec {mode!r}")
        self.mode = mode
        self.vocab_size = int(vocab_size)

    def encode(self, text: str) -> list[int]:
        if self.mode == "ids":
            try:
                return [int(t) for t in text.split()]
            except ValueError:
                raise ValueError(
                    "text-codec 'ids' expects space-separated decimal "
                    "token ids (serve with --text-codec bytes for "
                    "UTF-8 byte-level prompts)") from None
        toks = list(text.encode("utf-8"))
        if self.vocab_size and self.vocab_size < 256:
            raise ValueError(
                f"text-codec 'bytes' needs vocab >= 256, have "
                f"{self.vocab_size}")
        return toks

    def decode(self, tokens) -> str:
        if self.mode == "ids":
            return " ".join(str(int(t)) for t in tokens)
        # out-of-byte-range ids decode as U+FFFD: emit the full
        # replacement-char UTF-8 sequence, never a bare lead byte that
        # would swallow the NEXT valid tokens into one wrong character
        out = bytearray()
        for t in tokens:
            t = int(t)
            if 0 <= t < 256:
                out.append(t)
            else:
                out += b"\xef\xbf\xbd"
        return out.decode("utf-8", errors="replace")


# ---- request parsing ------------------------------------------------------

def _common_params(payload: dict) -> dict:
    """The params shared by both /v1 endpoints, validated. Unknown
    params are ignored (OpenAI tolerance), but a few poisoned ones are
    rejected loudly rather than silently mis-served."""
    if payload.get("n") not in (None, 1):
        raise ValueError("n != 1 is not supported")
    if payload.get("stream") is not None and not isinstance(
            payload["stream"], bool):
        raise ValueError("stream must be a JSON boolean")
    out = {
        "max_new_tokens": int(payload.get("max_tokens", 16)),
        "stream": bool(payload.get("stream", False)),
        "model": payload.get("model"),
    }
    if out["model"] is not None and not isinstance(out["model"], str):
        raise ValueError("model must be a string")
    if payload.get("temperature") is not None:
        out["temperature"] = float(payload["temperature"])
    if payload.get("top_k") is not None:
        out["top_k"] = int(payload["top_k"])
    timeout = float(payload.get("timeout_s", 600.0))
    if not 0 < timeout < float("inf"):
        raise ValueError("timeout_s must be a positive finite number")
    out["timeout_s"] = timeout
    # admission tier (engine PRIORITY_CLASSES): "interactive" (default)
    # is shed last, "batch" first — validated here so a typo'd tier is
    # a 400, not a silently-interactive request
    pri = payload.get("priority")
    if pri is not None:
        if pri not in ("interactive", "batch"):
            raise ValueError(
                "priority must be 'interactive' or 'batch'")
        out["priority"] = pri
    return out


def _parse_stop(payload: dict, codec: TokenCodec) -> list | None:
    """``stop``: a string or a list of strings (the OpenAI shape),
    codec-encoded into token-id sequences — or raw token-id lists for
    token-native clients. None when absent."""
    stop = payload.get("stop")
    if stop is None:
        return None
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, list) or not stop:
        raise ValueError("stop must be a string or a non-empty list")
    out = []
    for item in stop:
        if isinstance(item, str):
            seq = codec.encode(item)
        elif isinstance(item, (list, tuple)) and item and all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in item):
            seq = [int(t) for t in item]
        else:
            raise ValueError(
                "each stop entry must be a string or a non-empty "
                "token-id list")
        if not seq:
            raise ValueError("a stop entry encoded to an empty sequence")
        out.append(seq)
    return out


def parse_completion_request(payload: dict, codec: TokenCodec) -> dict:
    """``POST /v1/completions`` body -> engine kwargs:
    {prompt_tokens, max_new_tokens, temperature?, top_k?, stream,
    model, timeout_s}. ``prompt`` may be a string (codec-encoded) or a
    token-id array."""
    out = _common_params(payload)
    prompt = payload.get("prompt")
    if isinstance(prompt, str):
        out["prompt_tokens"] = codec.encode(prompt)
    elif isinstance(prompt, (list, tuple)) and prompt and all(
            isinstance(t, (int, float)) and not isinstance(t, bool)
            for t in prompt):
        out["prompt_tokens"] = [int(t) for t in prompt]
    else:
        raise ValueError(
            "prompt must be a non-empty token-id array or a string")
    out["stop_sequences"] = _parse_stop(payload, codec)
    lp = payload.get("logprobs", 0)
    if lp is None:
        lp = 0
    if isinstance(lp, bool) or not isinstance(lp, int) or lp < 0:
        raise ValueError("logprobs must be a non-negative integer")
    out["logprobs"] = lp
    if lp and out["stream"]:
        raise ValueError("logprobs are unavailable on streamed "
                         "requests (buffered responses only)")
    return out


def parse_chat_request(payload: dict, codec: TokenCodec) -> dict:
    """``POST /v1/chat/completions`` body -> engine kwargs (same shape
    as ``parse_completion_request``). The chat template is the
    identity concatenation of the messages' codec-encoded contents, in
    order (module docstring)."""
    out = _common_params(payload)
    messages = payload.get("messages")
    if not isinstance(messages, list) or not messages:
        raise ValueError("messages must be a non-empty array")
    toks: list[int] = []
    for m in messages:
        if not isinstance(m, dict) or not isinstance(m.get("content"),
                                                     str):
            raise ValueError(
                "each message needs a string 'content' field")
        toks.extend(codec.encode(m["content"]))
    if not toks:
        raise ValueError("messages encode to an empty prompt")
    out["prompt_tokens"] = toks
    out["stop_sequences"] = _parse_stop(payload, codec)
    # chat logprobs: the boolean switch + optional top_logprobs count
    # (the OpenAI chat shape) collapse to one engine k
    lp_on = payload.get("logprobs", False)
    if lp_on is None:
        lp_on = False
    if not isinstance(lp_on, bool):
        raise ValueError("logprobs must be a JSON boolean")
    top_lp = payload.get("top_logprobs", 0) or 0
    if isinstance(top_lp, bool) or not isinstance(top_lp, int) \
            or top_lp < 0:
        raise ValueError("top_logprobs must be a non-negative integer")
    out["logprobs"] = (max(1, top_lp) if lp_on else 0)
    if out["logprobs"] and out["stream"]:
        raise ValueError("logprobs are unavailable on streamed "
                         "requests (buffered responses only)")
    return out


# ---- response building ----------------------------------------------------

def map_finish_reason(engine_reason: str) -> str:
    return FINISH_REASON_MAP.get(engine_reason, engine_reason)


def _usage(prompt_tokens: int, completion_tokens: int) -> dict:
    return {"prompt_tokens": int(prompt_tokens),
            "completion_tokens": int(completion_tokens),
            "total_tokens": int(prompt_tokens) + int(completion_tokens)}


def _fmt_completion_logprobs(raw, codec: TokenCodec) -> dict | None:
    """Engine logprob entries -> the /v1/completions ``logprobs``
    object: per-token decoded text, the chosen token's logprob (null
    for a replayed teacher-forced prefix), and the top alternatives as
    {decoded: logprob} maps."""
    if raw is None:
        return None
    tokens, token_lps, tops = [], [], []
    for e in raw:
        tokens.append(codec.decode([e["token"]]))
        token_lps.append(e.get("logprob"))
        top = e.get("top")
        tops.append(
            {codec.decode([t]): lp for t, lp in zip(top[0], top[1])}
            if top else None)
    return {"tokens": tokens, "token_logprobs": token_lps,
            "top_logprobs": tops}


def _fmt_chat_logprobs(raw, codec: TokenCodec) -> dict | None:
    """Engine logprob entries -> the /v1/chat ``logprobs.content``
    list (token/logprob/top_logprobs per emitted token)."""
    if raw is None:
        return None
    content = []
    for e in raw:
        top = e.get("top")
        content.append({
            "token": codec.decode([e["token"]]),
            "logprob": e.get("logprob"),
            "top_logprobs": [
                {"token": codec.decode([t]), "logprob": lp}
                for t, lp in zip(top[0], top[1])] if top else []})
    return {"content": content}


def completion_response(rid, model: str, tokens, finish_reason: str,
                        prompt_tokens: int, codec: TokenCodec,
                        logprobs=None) -> dict:
    return {
        "id": f"cmpl-{rid}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "text": codec.decode(tokens),
            "tokens": [int(t) for t in tokens],
            "finish_reason": map_finish_reason(finish_reason),
            "logprobs": _fmt_completion_logprobs(logprobs, codec),
        }],
        "usage": _usage(prompt_tokens, len(tokens)),
    }


def chat_response(rid, model: str, tokens, finish_reason: str,
                  prompt_tokens: int, codec: TokenCodec,
                  logprobs=None) -> dict:
    return {
        "id": f"chatcmpl-{rid}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant",
                        "content": codec.decode(tokens)},
            "tokens": [int(t) for t in tokens],
            "finish_reason": map_finish_reason(finish_reason),
            "logprobs": _fmt_chat_logprobs(logprobs, codec),
        }],
        "usage": _usage(prompt_tokens, len(tokens)),
    }


def completion_chunk(rid, model: str, tokens, codec: TokenCodec,
                     finish_reason: str | None = None) -> dict:
    """One streamed /v1/completions SSE frame: a token-delta while
    ``finish_reason`` is None, the closing frame otherwise (empty
    delta, the mapped reason)."""
    return {
        "id": f"cmpl-{rid}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "text": codec.decode(tokens),
            "tokens": [int(t) for t in tokens],
            "finish_reason": (None if finish_reason is None
                              else map_finish_reason(finish_reason)),
        }],
    }


def stream_frame_fns(rid, model: str, codec: TokenCodec, chat: bool,
                     skip: int = 0, collect: list | None = None,
                     trace_id: str | None = None):
    """The three byte-builders one /v1 SSE relay needs:
    ``frame(tokens)`` per delta (the first chat delta carries the
    assistant role), ``final(reason)`` = closing chunk + ``[DONE]``,
    ``err(message)`` = the in-band OpenAI error envelope.

    SSE reconnect: every
    delta/closing frame carries an ``id: <rid>:<abs>`` line — the
    absolute emitted-token cursor a client echoes back as
    ``Last-Event-ID``. On a resumed stream ``skip`` already-acked
    tokens are withheld (the engine re-emits the teacher-forced resume
    prefix; the client saw it). ``collect`` (when given) accumulates
    every token the stream carried — resume prefix included — so the
    caller can park it for the NEXT reconnect at disconnect.
    ``trace_id`` (when given) rides the CLOSING chunk only — the
    distributed-tracing echo for streamed /v1 clients, mirroring the
    buffered path's X-Tony-Trace-Id response header (streaming headers
    are sent before the id is worth echoing mid-retry)."""
    first = {"v": True}
    seen = {"n": 0}

    def frame(toks):
        toks = [int(t) for t in toks]
        if collect is not None:
            collect.extend(toks)
        start = max(0, skip - seen["n"])
        seen["n"] += len(toks)
        toks = toks[start:]
        if not toks:
            # fully acked (resume replay): nothing to re-deliver; the
            # role delta (chat) rides the first frame with NEW tokens
            return b""
        if chat:
            obj = chat_chunk(rid, model, toks, codec, first=first["v"])
            first["v"] = False
        else:
            obj = completion_chunk(rid, model, toks, codec)
        return sse_frame(obj, event_id=f"{rid}:{seen['n']}")

    def final(reason):
        obj = (chat_chunk(rid, model, [], codec, finish_reason=reason,
                          first=first["v"]) if chat
               else completion_chunk(rid, model, [], codec,
                                     finish_reason=reason))
        if trace_id is not None:
            obj["trace_id"] = trace_id
        return sse_frame(obj, event_id=f"{rid}:{seen['n']}") + SSE_DONE

    def err(msg):
        return sse_frame({"error": {"message": str(msg),
                                    "type": "server_error"}})

    return frame, final, err


def chat_chunk(rid, model: str, tokens, codec: TokenCodec,
               finish_reason: str | None = None, first: bool = False)\
        -> dict:
    """One streamed /v1/chat/completions SSE frame; the first delta
    carries the assistant role (the OpenAI stream contract)."""
    delta: dict = {}
    if first:
        delta["role"] = "assistant"
    if tokens:
        delta["content"] = codec.decode(tokens)
    return {
        "id": f"chatcmpl-{rid}",
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "delta": delta,
            "tokens": [int(t) for t in tokens],
            "finish_reason": (None if finish_reason is None
                              else map_finish_reason(finish_reason)),
        }],
    }
