"""The serving API's host-side pieces (the port's own copy of the JAX
package's api/ modules it needs): ``stream`` (the per-request token channel
and SSE framing) and ``openai`` (the /v1 payload mapping and the text
codec). The JAX package's control-plane dataclasses are not part of the
serving path and are not copied."""
