"""Telemetry hygiene rules (``tel-*``): the counterpart of
``photon_ml_tpu/analysis/rules_telemetry.py``, with every home moved from
``photon_ml_tpu/`` to ``photon_ml_tpu_torch/``. ``tel-retained-vocab``
reads the closed series vocabulary of the port's ``telemetry/history.py``,
and ``tel-drift-home``'s array modules are numpy and torch (the port's
counterpart of ``jax.numpy``, with ``torch.histc`` beside the
``histogram`` family).
"""

from __future__ import annotations

import ast
import os
import re

from photon_ml_tpu_torch.analysis.engine import FileContext, rule

#: stdout owners: the CLI drivers and the module runners (the package's,
#: and the lint's own, which the reference keeps in tools/)
PRINT_ALLOWED_PREFIXES = (
    os.path.join("photon_ml_tpu_torch", "cli") + os.sep,
)
PRINT_ALLOWED_FILES = {
    os.path.join("photon_ml_tpu_torch", "__main__.py"),
    os.path.join("photon_ml_tpu_torch", "analysis", "__main__.py"),
}

#: the one subtree whose job IS timing: the sanctioned timers live here
TIMING_ALLOWED_PREFIX = os.path.join("photon_ml_tpu_torch",
                                     "telemetry") + os.sep

#: the one place allowed to construct MetricsRegistry instances
REGISTRY_ALLOWED_PREFIX = os.path.join("photon_ml_tpu_torch",
                                       "telemetry") + os.sep

#: metric-family registration methods/functions
METRIC_FACTORIES = frozenset({"counter", "gauge", "histogram"})

METRIC_NAME_RE = re.compile(r"photon_[a-z0-9_]+\Z")

#: the one subtree whose job IS score binning + drift statistics
QUALITY_ALLOWED_PREFIX = os.path.join("photon_ml_tpu_torch",
                                      "quality") + os.sep

#: numpy/torch histogram-binning entry points
HISTOGRAM_ATTRS = frozenset({"histogram", "histogram2d", "histogramdd",
                             "histogram_bin_edges", "histc"})

#: drift-statistic names whose DEFINITION outside quality/ forks the
#: arithmetic (calling quality's exported functions is of course fine)
DRIFT_STAT_NAMES = frozenset({"population_stability_index", "psi",
                              "ks_statistic", "kolmogorov_smirnov"})

#: the one request-id mint (serving/http.py) and the request-id
#: generation primitives whose CALL anywhere else forks request identity
REQUEST_ID_ALLOWED_FILES = {os.path.join("photon_ml_tpu_torch", "serving",
                                         "http.py")}
ID_GEN_UUID_FNS = frozenset({"uuid1", "uuid3", "uuid4", "uuid5"})
ID_GEN_SECRETS_FNS = frozenset({"token_hex", "token_urlsafe"})

#: the one RequestLogAvro writer (serving/reqlog.py) plus the schema's
#: definition site
REQLOG_SCHEMA_NAME = "REQUEST_LOG_AVRO"
REQLOG_ALLOWED_FILES = {
    os.path.join("photon_ml_tpu_torch", "serving", "reqlog.py"),
    os.path.join("photon_ml_tpu_torch", "io", "schemas.py"),
}


def _print_ok(ctx: FileContext) -> bool:
    return (ctx.path in PRINT_ALLOWED_FILES
            or any(ctx.path.startswith(p) for p in PRINT_ALLOWED_PREFIXES))


@rule("tel-print",
      "no print() outside CLI entry points — stdout belongs to the drivers")
def check_print(ctx: FileContext):
    if _print_ok(ctx):
        return
    for node in ctx.walk():
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "print"):
            yield ctx.finding(
                "tel-print", node,
                "print() outside a CLI entry point — library code logs, "
                "counts (telemetry.metrics) or spans (telemetry.tracing); "
                "stdout belongs to the drivers")


def _is_perf_counter(node: ast.AST, time_aliases: set[str],
                     pc_names: set[str]) -> bool:
    if isinstance(node, ast.Attribute) and node.attr == "perf_counter":
        return (isinstance(node.value, ast.Name)
                and node.value.id in time_aliases)
    if isinstance(node, ast.Name):
        return node.id in pc_names
    return False


@rule("tel-perf-counter",
      "no time.perf_counter outside telemetry/ — durations route through "
      "registry timers/spans")
def check_perf_counter(ctx: FileContext):
    if ctx.path.startswith(TIMING_ALLOWED_PREFIX):
        return
    time_aliases = ctx.module_aliases("time")
    pc_names = ctx.from_aliases("time", "perf_counter")
    for node in ctx.walk():
        if _is_perf_counter(node, time_aliases, pc_names):
            yield ctx.finding(
                "tel-perf-counter", node,
                "time.perf_counter outside telemetry/ — measure durations "
                "through the metrics registry's Histogram.time() or a "
                "tracing span so /metrics and trace.jsonl see them")


@rule("tel-wall-clock",
      "no wall-clock duration arithmetic — time.time() is a timestamp, "
      "not a timer")
def check_wall_clock(ctx: FileContext):
    if ctx.path.startswith(TIMING_ALLOWED_PREFIX):
        return
    time_aliases = ctx.module_aliases("time")
    tt_names = ctx.from_aliases("time", "time")

    def _is_wall_clock_call(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "time":
            return (isinstance(f.value, ast.Name)
                    and f.value.id in time_aliases)
        return isinstance(f, ast.Name) and f.id in tt_names

    for node in ctx.walk():
        if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)
                and (_is_wall_clock_call(node.left)
                     or _is_wall_clock_call(node.right))):
            yield ctx.finding(
                "tel-wall-clock", node,
                "duration computed from time.time() — the wall clock is "
                "for timestamps (it jumps); measure durations with a "
                "registry timer or a tracing span")


def _metric_call_args(node: ast.Call):
    """(name, help) literals of a metric-factory call; non-literal fields
    come back as None (dynamic names/helps are out of the lint's reach —
    the registry's internal plumbing passes them through variables)."""
    name = help_ = None
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        name = node.args[0].value
    if len(node.args) > 1 and isinstance(node.args[1], ast.Constant) \
            and isinstance(node.args[1].value, str):
        help_ = node.args[1].value
    for kw in node.keywords:
        if kw.arg == "help_" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            help_ = kw.value.value
    has_help_arg = len(node.args) > 1 or any(kw.arg == "help_"
                                             for kw in node.keywords)
    return name, help_, has_help_arg


def _factory_calls(ctx: FileContext):
    """Every metric-factory call node in the file (attribute spelling on
    any receiver, or a from-imported factory name)."""
    metric_fn_names = ctx.from_aliases(
        "photon_ml_tpu_torch.telemetry.metrics",
        *METRIC_FACTORIES)
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if ((isinstance(func, ast.Attribute)
             and func.attr in METRIC_FACTORIES)
                or (isinstance(func, ast.Name)
                    and func.id in metric_fn_names)):
            yield node


@rule("tel-metric-name",
      "literal metric names match photon_[a-z0-9_]+ and carry help text")
def check_metric_name(ctx: FileContext):
    for node in _factory_calls(ctx):
        name, help_, has_help = _metric_call_args(node)
        if name is None:
            continue
        if not METRIC_NAME_RE.fullmatch(name):
            yield ctx.finding(
                "tel-metric-name", node,
                f"metric name {name!r} must match photon_[a-z0-9_]+ — the "
                f"fleet aggregate merges by family name, so every family "
                f"carries the photon_ prefix")
        if not has_help or (help_ is not None and not help_.strip()):
            yield ctx.finding(
                "tel-metric-name", node,
                f"metric {name!r} registered without help text — a scrape "
                f"nobody can interpret; say what the number means")


@rule("tel-registry",
      "no MetricsRegistry() outside telemetry/ — one process-global "
      "registry")
def check_registry(ctx: FileContext):
    if ctx.path.startswith(REGISTRY_ALLOWED_PREFIX):
        return
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if ((isinstance(func, ast.Name) and func.id == "MetricsRegistry")
                or (isinstance(func, ast.Attribute)
                    and func.attr == "MetricsRegistry")):
            yield ctx.finding(
                "tel-registry", node,
                "MetricsRegistry() outside photon_ml_tpu_torch/telemetry/ "
                "— the "
                "process-global default_registry() is the only sanctioned "
                "registry outside tests; a private one forks the namespace "
                "away from /metrics and the fleet fold")


def _np_aliases(ctx: FileContext) -> set[str]:
    return ctx.module_aliases("numpy") | ctx.module_aliases("torch")


@rule("tel-drift-home",
      "score binning + PSI/KS live in quality/ — one drift arithmetic")
def check_drift_home(ctx: FileContext):
    if ctx.path.startswith(QUALITY_ALLOWED_PREFIX):
        return
    np_aliases = _np_aliases(ctx)

    def _is_np_module(v: ast.AST) -> bool:
        return isinstance(v, ast.Name) and v.id in np_aliases

    for node in ctx.walk():
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in HISTOGRAM_ATTRS
                and _is_np_module(node.func.value)):
            yield ctx.finding(
                "tel-drift-home", node,
                f"{node.func.attr}() outside photon_ml_tpu_torch/quality/ — "
                f"score-histogram binning lives in quality/baseline.py "
                f"(bin_scores/quantile_edges) so live and baseline "
                f"distributions always share bin edges; a second binning "
                f"silently redefines drift")
        elif (isinstance(node, ast.FunctionDef)
              and node.name in DRIFT_STAT_NAMES):
            yield ctx.finding(
                "tel-drift-home", node,
                f"drift statistic {node.name}() defined outside "
                f"photon_ml_tpu_torch/quality/ — PSI/KS have ONE "
                f"implementation "
                f"(quality/baseline.py); import it instead of re-deriving "
                f"the arithmetic")


@rule("tel-request-identity",
      "request ids are minted in serving/http.py only; RequestLogAvro is "
      "written by serving/reqlog.py only")
def check_request_identity(ctx: FileContext):
    uuid_aliases = ctx.module_aliases("uuid")
    secrets_aliases = ctx.module_aliases("secrets")
    id_gen_names = (ctx.from_aliases("uuid", *ID_GEN_UUID_FNS)
                    | ctx.from_aliases("secrets", *ID_GEN_SECRETS_FNS))

    def _is_id_gen_call(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            return ((f.value.id in uuid_aliases
                     and f.attr in ID_GEN_UUID_FNS)
                    or (f.value.id in secrets_aliases
                        and f.attr in ID_GEN_SECRETS_FNS))
        return isinstance(f, ast.Name) and f.id in id_gen_names

    def _is_reqlog_schema_ref(node: ast.AST) -> bool:
        if isinstance(node, ast.Name) and node.id == REQLOG_SCHEMA_NAME:
            return True
        if isinstance(node, ast.Attribute) and node.attr == REQLOG_SCHEMA_NAME:
            return True
        return (isinstance(node, ast.ImportFrom)
                and any(a.name == REQLOG_SCHEMA_NAME for a in node.names))

    id_gen_banned = ctx.path not in REQUEST_ID_ALLOWED_FILES
    reqlog_banned = ctx.path not in REQLOG_ALLOWED_FILES
    for node in ctx.walk():
        if id_gen_banned and _is_id_gen_call(node):
            yield ctx.finding(
                "tel-request-identity", node,
                "request-id generation outside photon_ml_tpu_torch/serving/"
                "http.py — a serving request is identified ONCE "
                "(new_request_id); a second mint breaks the span/reqlog/"
                "response join (hygiene rule 7)")
        elif reqlog_banned and _is_reqlog_schema_ref(node):
            yield ctx.finding(
                "tel-request-identity", node,
                f"{REQLOG_SCHEMA_NAME} referenced outside "
                f"photon_ml_tpu_torch/serving/reqlog.py — the request log "
                f"has ONE writer; a second one forks the on-disk format "
                f"away from its reader, feedback/joiner.py (hygiene rule "
                f"7)")


#: names that carry raw REQUEST payload — a subscript/.get() on one of
#: these reaching a span attribute or metric label is unbounded
#: cardinality (every distinct entity id becomes its own series/tag)
REQUEST_PAYLOAD_NAMES = frozenset({
    "meta", "metadata", "metadatamap", "record", "records", "payload",
    "body", "params", "qs", "query",
})

#: bare local names that obviously hold a per-request entity identity
ENTITY_ID_NAME_RE = re.compile(
    r"\A(user|entity|item|song|member)_?id\Z", re.IGNORECASE)

#: span/annotation call names whose KEYWORDS become span attributes
SPAN_ATTR_CALLS = frozenset({"span", "span_under", "record_span",
                             "annotate", "set"})

#: keywords that are sanctioned tags: the request id is the designed
#: per-request join key (hygiene rule 7), and span_under/record_span
#: plumbing keywords aren't attributes at all
SANCTIONED_ATTR_KEYWORDS = frozenset({"request_id", "parent_id",
                                      "seconds", "ts"})


def _payload_root(node: ast.AST) -> bool:
    """True when the expression reads a raw request-payload field:
    ``meta["userId"]``, ``payload.get("memberId")``, ``record[...]`` —
    chased through attribute chains (``self.payload[...]``)."""
    if isinstance(node, ast.Subscript):
        return _payload_base(node.value)
    if (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"):
        return _payload_base(node.func.value)
    return False


def _payload_base(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id.lower() in REQUEST_PAYLOAD_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr.lower() in REQUEST_PAYLOAD_NAMES
    return False


def _unbounded_value(node: ast.AST) -> bool:
    """An attribute/label VALUE expression with unbounded request-derived
    cardinality: a payload subscript/get, an entity-id-named local, or
    an f-string / str() / concat wrapping one."""
    if _payload_root(node):
        return True
    if isinstance(node, ast.Name) and ENTITY_ID_NAME_RE.match(node.id):
        return True
    if isinstance(node, ast.JoinedStr):
        return any(_unbounded_value(v.value) for v in node.values
                   if isinstance(v, ast.FormattedValue))
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("str", "repr") and node.args):
        return _unbounded_value(node.args[0])
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return (_unbounded_value(node.left)
                or _unbounded_value(node.right))
    return False


@rule("tel-span-attr-cardinality",
      "no span attributes or metric label values derived from unbounded "
      "request fields — tags index storage, payloads don't belong there")
def check_span_attr_cardinality(ctx: FileContext):
    """Span attributes and metric labels are INDEXED: every distinct
    value is a new series (metrics) or a new tag value (trace tooling
    group-bys). A value read off the raw request payload — an entity id,
    a metadata field — is unbounded, so one hot user explodes the
    registry and the span tree's group keys. Bounded request identity
    already has sanctioned homes: the request id (hygiene rule 7) and
    the closed leg-summary stage vocabulary
    (``serving/http.py::parse_leg_summary`` — the parser DROPS unknown
    keys precisely so fleet trace stitching can never import a host's
    unbounded field names as span data)."""
    for node in ctx.walk():
        if not isinstance(node, ast.Call) or not node.keywords:
            continue
        func = node.func
        if isinstance(func, ast.Attribute):
            call_name = func.attr
        elif isinstance(func, ast.Name):
            call_name = func.id
        else:
            continue
        if call_name == "labels":
            kind = "metric label"
        elif call_name in SPAN_ATTR_CALLS:
            kind = "span attribute"
        else:
            continue
        for kw in node.keywords:
            if kw.arg is None or kw.arg in SANCTIONED_ATTR_KEYWORDS:
                continue
            if _unbounded_value(kw.value):
                yield ctx.finding(
                    "tel-span-attr-cardinality", node,
                    f"{kind} {kw.arg!r} set from a raw request field — "
                    f"unbounded cardinality: every distinct value becomes "
                    f"its own series/tag. Count it under a bounded label, "
                    f"or join through the request id (the sanctioned "
                    f"per-request key)")


#: the retained-telemetry plane's own plumbing: history/flightrec pass
#: names through variables they validate at runtime (SERIES_NAME_RE,
#: RECORD_KINDS) — the lint covers their CALLERS
RETAINED_ALLOWED_FILES = {
    os.path.join("photon_ml_tpu_torch", "telemetry", "history.py"),
    os.path.join("photon_ml_tpu_torch", "telemetry", "flightrec.py"),
}

#: retained-telemetry writers whose NAME argument joins the black box /
#: history vocabulary (FlightRecorder.note / record_event)
RETAINED_NAME_CALLS = frozenset({"note", "record_event"})

#: the static twin of telemetry.history.SERIES_NAME_RE
RETAINED_NAME_RE = re.compile(r"\A[a-z][a-z0-9_]{0,59}\Z")


@rule("tel-retained-vocab",
      "flight-recorder note/event names and history series names come "
      "from a closed literal vocabulary; payload fields stay out of the "
      "black box")
def check_retained_vocab(ctx: FileContext):
    """The retained-telemetry plane (telemetry/history.py ring,
    telemetry/flightrec.py black box) is indexed storage exactly like
    span attributes: ``tools/postmortem.py`` and the ``/history`` fold
    group by record names, so a COMPUTED name is an unbounded vocabulary
    (every distinct value becomes its own report key) and a payload-
    derived field value ships request data into crash dumps. Mirrors
    ``tel-span-attr-cardinality``: names must be literal snake_case,
    values may carry the request id (the sanctioned join key) but never
    raw payload reads; requested history series must be members of
    ``telemetry.history.HISTORY_SERIES``."""
    if ctx.path in RETAINED_ALLOWED_FILES:
        return
    from photon_ml_tpu_torch.telemetry.history import HISTORY_SERIES
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Attribute):
            call_name = func.attr
        elif isinstance(func, ast.Name):
            call_name = func.id
        else:
            continue
        if call_name == "history_payload":
            for kw in node.keywords:
                if kw.arg != "series":
                    continue
                if not isinstance(kw.value, (ast.List, ast.Tuple)):
                    continue  # computed lists are checked at runtime
                for elt in kw.value.elts:
                    if (isinstance(elt, ast.Constant)
                            and isinstance(elt.value, str)
                            and elt.value not in HISTORY_SERIES):
                        yield ctx.finding(
                            "tel-retained-vocab", elt,
                            f"history series {elt.value!r} outside the "
                            f"closed vocabulary (telemetry.history."
                            f"HISTORY_SERIES) — the fold and /history "
                            f"only serve derived series they can "
                            f"recompute")
            continue
        if call_name not in RETAINED_NAME_CALLS:
            continue
        if node.args:
            name_arg = node.args[0]
            if not (isinstance(name_arg, ast.Constant)
                    and isinstance(name_arg.value, str)):
                yield ctx.finding(
                    "tel-retained-vocab", node,
                    f"{call_name}() name computed at runtime — flight "
                    f"records are grouped by name in postmortems, so the "
                    f"vocabulary is closed: pass a literal snake_case "
                    f"string")
            elif not RETAINED_NAME_RE.match(name_arg.value):
                yield ctx.finding(
                    "tel-retained-vocab", node,
                    f"{call_name}() name {name_arg.value!r} outside the "
                    f"closed vocabulary — flight record names are "
                    f"snake_case literals")
        for kw in node.keywords:
            if kw.arg is None:
                yield ctx.finding(
                    "tel-retained-vocab", node,
                    f"{call_name}(**...) splats computed field names "
                    f"into the black box — the field vocabulary is "
                    f"closed; spell the fields as literal keywords")
            elif (kw.arg not in SANCTIONED_ATTR_KEYWORDS
                    and _unbounded_value(kw.value)):
                yield ctx.finding(
                    "tel-retained-vocab", node,
                    f"flight record field {kw.arg!r} set from a raw "
                    f"request field — crash dumps are retained and "
                    f"shared; join through the request id (the "
                    f"sanctioned per-request key) instead of shipping "
                    f"payload data")


#: the ONE connection-accounting home: socket-lifecycle metric families
#: (``photon_connection*``) and the ConnectionTracker primitive live in
#: serving/http.py; everything else observes connections through the
#: tracker's stats()/utilization() or the capacity plane's probes
CONN_HOME_FILE = os.path.join("photon_ml_tpu_torch", "serving", "http.py")
CONN_METRIC_PREFIX = "photon_connection"

#: static twin of ``telemetry.saturation.RESOURCES`` — the closed
#: USE-method resource vocabulary (a test asserts the copies agree, the
#: same pattern as RETAINED_NAME_RE vs SERIES_NAME_RE)
SATURATION_RESOURCES = frozenset({
    "device", "batcher_queue", "rank_batcher_queue", "http_connections",
    "handler_threads", "saver_pool", "router_pool", "hedge_pool",
    "reqlog",
})


@rule("tel-conn-home",
      "connection accounting lives in serving/http.py only; saturation "
      "probes register closed-vocabulary resource names")
def check_conn_home(ctx: FileContext):
    """The capacity plane's contracts. Connection accounting
    holds an identity (``accepted == closed + open``) that only survives
    because ONE tracker under ONE lock mutates it — a second
    ``photon_connection*`` family or a re-derived ConnectionTracker
    forks the arithmetic away from ``/healthz`` and the fold. And the
    USE-method gauges are keyed by resource name: ``add_probe`` with a
    computed or out-of-vocabulary name opens the label set that
    ``tools/capacity_report.py`` and the ``resource_util`` history
    series group by."""
    conn_banned = ctx.path != CONN_HOME_FILE
    for node in ctx.walk():
        if (conn_banned and isinstance(node, ast.ClassDef)
                and node.name == "ConnectionTracker"):
            yield ctx.finding(
                "tel-conn-home", node,
                "ConnectionTracker defined outside "
                "photon_ml_tpu_torch/serving/http.py — connection accounting has ONE home so the "
                "accepted == closed + open identity holds under one "
                "lock; import serving.http.ConnectionTracker instead")
            continue
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if (isinstance(func, ast.Attribute) and func.attr == "add_probe"
                and node.args):
            name_arg = node.args[0]
            if not (isinstance(name_arg, ast.Constant)
                    and isinstance(name_arg.value, str)):
                yield ctx.finding(
                    "tel-conn-home", node,
                    "add_probe() resource name computed at runtime — "
                    "the USE-method resource vocabulary is closed "
                    "(telemetry.saturation.RESOURCES); pass one of its "
                    "members as a literal")
            elif name_arg.value not in SATURATION_RESOURCES:
                yield ctx.finding(
                    "tel-conn-home", node,
                    f"add_probe() resource {name_arg.value!r} outside "
                    f"the closed vocabulary (telemetry.saturation."
                    f"RESOURCES) — capacity_report and the "
                    f"resource_util history series group by these "
                    f"names; additions are a reviewed vocabulary "
                    f"change, not a call-site invention")
    if conn_banned:
        for node in _factory_calls(ctx):
            name, _, _ = _metric_call_args(node)
            if name is not None and name.startswith(CONN_METRIC_PREFIX):
                yield ctx.finding(
                    "tel-conn-home", node,
                    f"connection metric {name!r} registered outside "
                    f"photon_ml_tpu_torch/serving/http.py — the socket-"
                    f"lifecycle families have ONE writer (the "
                    f"ConnectionTracker); a second family double-counts "
                    f"connections in the fleet fold")
