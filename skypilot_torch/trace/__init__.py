"""End-to-end distributed tracing of the port — its own copy of the JAX
package's tracer (docs/observability.md, Tracing).

Public surface:

    with trace.span('replica.generate', attrs={...}) as sp: ...
    trace.current() / trace.attach(ctx)
    trace.context_env()            # env stamp for child processes
    trace.format_traceparent() / trace.parse_traceparent(header)
    trace.record_span(...)         # explicit-timestamp emission

The read side (``skypilot_tpu.trace.collect``) is orchestration
tooling and reads the port's sink files as they are.
"""
from skypilot_torch.trace.tracer import (ENV_CONTEXT, TRACEPARENT_HEADER,
                                         Span, SpanContext, attach,
                                         child_context, chrome_export,
                                         component, context_env,
                                         current, emit_span, enabled,
                                         format_traceparent,
                                         parse_traceparent, record_span,
                                         reset_current, reset_sink,
                                         sample_root, set_component,
                                         set_current, sink_dir, span)

__all__ = [
    'ENV_CONTEXT', 'TRACEPARENT_HEADER', 'Span', 'SpanContext',
    'attach', 'child_context', 'chrome_export',
    'component', 'context_env', 'current', 'emit_span', 'enabled',
    'format_traceparent', 'parse_traceparent',
    'record_span', 'reset_current', 'reset_sink', 'sample_root',
    'set_component', 'set_current', 'sink_dir', 'span',
]
