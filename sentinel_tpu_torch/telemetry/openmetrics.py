"""Minimal OpenMetrics text renderer, no client-library dependency (port
of ``sentinel_tpu/telemetry/openmetrics.py``).

Emits the exposition format Prometheus scrapes and the OpenMetrics 1.0
parser accepts: ``# TYPE`` / ``# HELP`` metadata per family, samples with
escaped labels, histogram ``_bucket``/``_count``/``_sum`` series with a
``+Inf`` bucket, and the mandatory ``# EOF`` trailer. Families render in
registration order; within a family, samples in emission order: stable
output for diffing, and byte-equal to the JAX package's for the same
calls.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")

# Escaping per the OpenMetrics 1.0 ABNF: label VALUES escape backslash,
# double-quote and newline; HELP text escapes only backslash and newline
# (a quote is legal there verbatim — escaping it produces the invalid
# sequence ``\"`` strict parsers reject).
_LABEL_ESCAPES = {"\\": "\\\\", "\"": "\\\"", "\n": "\\n"}
_HELP_ESCAPES = {"\\": "\\\\", "\n": "\\n"}


def _escape_label(v: str) -> str:
    return "".join(_LABEL_ESCAPES.get(ch, ch) for ch in str(v))


def _escape_help(v: str) -> str:
    return "".join(_HELP_ESCAPES.get(ch, ch) for ch in str(v))


def _fmt_value(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


class OpenMetricsBuilder:
    """Accumulate metric families, then :meth:`render` the exposition."""

    def __init__(self):
        self._lines: List[str] = []

    def family(self, name: str, mtype: str, help_text: str) -> None:
        """Start a family. ``mtype``: gauge | counter | histogram | info."""
        self._lines.append(f"# TYPE {name} {mtype}")
        if help_text:
            self._lines.append(f"# HELP {name} {_escape_help(help_text)}")

    def sample(self, name: str, labels: Optional[Dict[str, str]],
               value) -> None:
        self._lines.append(f"{name}{_labels(labels)} {_fmt_value(value)}")

    def counter(self, name: str, help_text: str, value,
                labels: Optional[Dict[str, str]] = None) -> None:
        """One-sample counter family (cumulative; ``_total`` suffix)."""
        self.family(name, "counter", help_text)
        self.sample(name + "_total", labels, value)

    def histogram(self, name: str, labels: Dict[str, str],
                  edges: Sequence[float], bucket_counts: Sequence[float],
                  total_sum: float,
                  exemplars: Optional[Dict[int, Tuple[Dict[str, str],
                                                      float,
                                                      Optional[float]]]]
                  = None) -> None:
        """Histogram samples for ONE label set of an already-declared
        family: per-bucket counts (same indexing as ``edges`` plus one
        overflow) render as cumulative ``le`` buckets + ``+Inf`` +
        ``_count`` / ``_sum``.

        ``exemplars`` (OpenMetrics 1.0): bucket index -> (labelset,
        observed value, optional unix timestamp in SECONDS); renders as
        the ``# {trace_id="..."} value ts`` suffix on that bucket line —
        the waterfall's latency-bucket -> stitched-trace join."""
        cum = 0.0
        for b, (edge, cnt) in enumerate(zip(edges, bucket_counts)):
            cum += float(cnt)
            self._bucket_line(name, {**labels, "le": _fmt_value(edge)},
                              cum, exemplars.get(b) if exemplars else None)
        cum += float(bucket_counts[len(edges)]) \
            if len(bucket_counts) > len(edges) else 0.0
        self._bucket_line(name, {**labels, "le": "+Inf"}, cum,
                          exemplars.get(len(edges)) if exemplars else None)
        self.sample(name + "_count", labels, cum)
        self.sample(name + "_sum", labels, total_sum)

    def _bucket_line(self, name: str, labels: Dict[str, str], value,
                     exemplar) -> None:
        line = f"{name}_bucket{_labels(labels)} {_fmt_value(value)}"
        if exemplar is not None:
            ex_labels, ex_value, ex_ts = exemplar
            line += f" # {_labels(ex_labels)} {_fmt_value(ex_value)}"
            if ex_ts is not None:
                line += f" {_fmt_value(ex_ts)}"
        self._lines.append(line)

    def render(self) -> str:
        return "\n".join(self._lines + ["# EOF", ""])


def parse_families(text: str) -> Dict[str, List[Tuple[str, Dict, float]]]:
    """Tiny exposition parser: family name -> [(sample_name, labels,
    value)]. Dependency-free fallback used by tests/tools when the
    prometheus_client OpenMetrics parser is unavailable; NOT a validator.
    """
    out: Dict[str, List[Tuple[str, Dict, float]]] = {}
    family = None
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            family = line.split()[2]
            out.setdefault(family, [])
            continue
        if not line or line.startswith("#"):
            continue
        # Strip any exemplar suffix (``... # {labels} value ts``) —
        # this fallback reads sample values, not exemplars.
        line = line.split(" # ", 1)[0]
        head, _, val = line.rpartition(" ")
        labels: Dict[str, str] = {}
        name = head
        if "{" in head:
            name, _, rest = head.partition("{")
            for part in rest.rstrip("}").split(","):
                if "=" in part:
                    k, _, v = part.partition("=")
                    labels[k] = v.strip('"')
        key = family if family and name.startswith(family) else name
        out.setdefault(key, []).append((name, labels, float(val)))
    return out
