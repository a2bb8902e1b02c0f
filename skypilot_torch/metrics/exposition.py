"""Prometheus text exposition: render a Registry, parse it back — a copy
of ``skypilot_tpu/metrics/exposition.py`` (stdlib only): the port's
text is byte-equal to the JAX package's for the same registry.

The renderer emits the Prometheus text format (version 0.0.4):

    # HELP skytpu_lb_requests_total Proxied requests.
    # TYPE skytpu_lb_requests_total counter
    skytpu_lb_requests_total{endpoint="http://...",code="200"} 42

The parser is the other half of the JAX package's scraper
(``skypilot_tpu/metrics/scrape.py``):
it understands exactly what the renderer emits plus the common
Prometheus dialect (escaped label values, +Inf/NaN, ignored comments)
so the orchestration side can also scrape third-party exporters
running on hosts.
"""
import math
from typing import Dict, List, NamedTuple, Tuple

_ESCAPES = {'\\': '\\\\', '\n': '\\n', '"': '\\"'}


def _escape_label_value(value: str) -> str:
    return ''.join(_ESCAPES.get(c, c) for c in value)


def _unescape_label_value(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == '\\' and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({'n': '\n', '\\': '\\', '"': '"'}.get(
                nxt, '\\' + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return ''.join(out)


def format_value(value: float) -> str:
    if math.isinf(value):
        return '+Inf' if value > 0 else '-Inf'
    if math.isnan(value):
        return 'NaN'
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def format_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    """``{k="v",...}`` (escaped), '' when unlabeled — the one label
    serializer (the scraper's re-renderer uses it too)."""
    if not labels:
        return ''
    inner = ','.join(f'{k}="{_escape_label_value(str(v))}"'
                     for k, v in labels)
    return '{' + inner + '}'


_labels_str = format_labels


def render_text(registry,
                extra_labels: Tuple[Tuple[str, str], ...] = ()
                ) -> str:
    """Render every family in ``registry`` as Prometheus text.
    ``extra_labels`` are injected before each sample's own labels
    (the textfile publisher stamps its ``proc`` identity this way —
    metrics/publish.py)."""
    extra = tuple((str(k), str(v)) for k, v in extra_labels)
    lines: List[str] = []
    for fam in registry.families():
        if fam.help:
            help_text = fam.help.replace('\\', '\\\\').replace(
                '\n', '\\n')
            lines.append(f'# HELP {fam.name} {help_text}')
        lines.append(f'# TYPE {fam.name} {fam.kind}')
        for labels, child in fam.collect():
            labels = extra + labels
            if fam.kind == 'histogram':
                cumulative, total_sum, count = child.snapshot()
                edges = list(fam.buckets) + [math.inf]
                for edge, cum in zip(edges, cumulative):
                    le = labels + (('le', format_value(edge)),)
                    lines.append(f'{fam.name}_bucket'
                                 f'{_labels_str(le)} {cum}')
                lines.append(f'{fam.name}_sum{_labels_str(labels)} '
                             f'{format_value(total_sum)}')
                lines.append(f'{fam.name}_count{_labels_str(labels)} '
                             f'{count}')
            else:
                lines.append(f'{fam.name}{_labels_str(labels)} '
                             f'{format_value(child.value)}')
    return '\n'.join(lines) + ('\n' if lines else '')


class Sample(NamedTuple):
    name: str
    labels: Tuple[Tuple[str, str], ...]
    value: float


class Series(NamedTuple):
    """One parsed family: kind may be '' when no # TYPE line seen."""
    name: str
    kind: str
    help: str
    samples: List[Sample]


def _parse_value(text: str) -> float:
    text = text.strip()
    if text == '+Inf':
        return math.inf
    if text == '-Inf':
        return -math.inf
    if text == 'NaN':
        return math.nan
    return float(text)


def _parse_labels(text: str) -> Tuple[Tuple[str, str], ...]:
    out: List[Tuple[str, str]] = []
    i = 0
    while i < len(text):
        eq = text.index('=', i)
        name = text[i:eq].strip().strip(',').strip()
        assert text[eq + 1] == '"', f'malformed labels: {text!r}'
        j = eq + 2
        while True:
            j = text.index('"', j)
            backslashes = 0
            k = j - 1
            while k >= 0 and text[k] == '\\':
                backslashes += 1
                k -= 1
            if backslashes % 2 == 0:
                break
            j += 1
        out.append((name, _unescape_label_value(text[eq + 2:j])))
        i = j + 1
    return tuple(out)


def parse_text(text: str) -> Dict[str, Series]:
    """Parse Prometheus text into {family_name: Series}.

    Histogram ``_bucket``/``_sum``/``_count`` samples are grouped
    under their base family name (matching how the renderer and
    Prometheus itself treat them)."""
    families: Dict[str, Series] = {}
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}

    def family_for(sample_name: str) -> str:
        for suffix in ('_bucket', '_sum', '_count'):
            base = sample_name[:-len(suffix)] \
                if sample_name.endswith(suffix) else None
            if base and kinds.get(base) == 'histogram':
                return base
        return sample_name

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith('#'):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == 'TYPE':
                kinds[parts[2]] = parts[3].strip() if len(parts) > 3 \
                    else ''
            elif len(parts) >= 3 and parts[1] == 'HELP':
                helps[parts[2]] = parts[3] if len(parts) > 3 else ''
            continue
        if '{' in line:
            name = line[:line.index('{')]
            rest = line[line.index('{') + 1:]
            close = rest.rindex('}')
            labels = _parse_labels(rest[:close])
            value = _parse_value(rest[close + 1:])
        else:
            name, _, value_str = line.partition(' ')
            labels = ()
            value = _parse_value(value_str)
        base = family_for(name)
        series = families.get(base)
        if series is None:
            series = Series(base, kinds.get(base, ''),
                            helps.get(base, ''), [])
            families[base] = series
        series.samples.append(Sample(name, labels, value))
    # Late # TYPE/HELP lines (or any order): refresh metadata.
    out: Dict[str, Series] = {}
    for base, series in families.items():
        out[base] = Series(base, kinds.get(base, series.kind),
                           helps.get(base, series.help),
                           series.samples)
    return out
