"""Resilience hygiene rules (``res-*``): the counterpart of
``photon_ml_tpu/analysis/rules_resilience.py``, with every home moved
from ``photon_ml_tpu/`` to ``photon_ml_tpu_torch/`` and the alias checks
looking for the port's module names (``photon_ml_tpu_torch.fleet.
sharding``, ``photon_ml_tpu_torch.serving[.reqlog]``).

One difference: the reference also lets ``tools/reqlog_replay.py`` read
the request log. The port has no replay tool, so its one sanctioned
reader outside ``serving/reqlog.py`` is ``feedback/joiner.py``.
"""

from __future__ import annotations

import ast
import os

from photon_ml_tpu_torch.analysis.engine import FileContext, rule

#: the one module allowed to sleep (it owns backoff + injected stalls)
SLEEP_ALLOWED = {os.path.join("photon_ml_tpu_torch", "resilience", "retry.py")}

#: the package prefix allowed to write model part-files (it owns the
#: atomic staged publish)
PART_WRITE_ALLOWED_PREFIX = os.path.join("photon_ml_tpu_torch", "io") + os.sep

#: the one module allowed to spawn or signal processes (it owns the
#: fleet's process lifecycle)
PROCESS_ALLOWED = {os.path.join("photon_ml_tpu_torch", "resilience",
                                "supervisor.py")}

#: the one module allowed to write/derive serving coefficient tables
#: (EntityCoefficientStore.build / apply_patch)
STORE_ALLOWED = {os.path.join("photon_ml_tpu_torch", "serving", "store.py")}


@rule("res-bare-except",
      "no bare `except:` — it swallows KeyboardInterrupt/SystemExit")
def check_bare_except(ctx: FileContext):
    for node in ctx.walk():
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            yield ctx.finding(
                "res-bare-except", node,
                "bare `except:` — catch a type (it swallows "
                "KeyboardInterrupt/SystemExit)")


def _is_time_sleep(node: ast.AST, time_aliases: set[str],
                   sleep_names: set[str]) -> bool:
    if isinstance(node, ast.Attribute) and node.attr == "sleep":
        return isinstance(node.value, ast.Name) and node.value.id in time_aliases
    if isinstance(node, ast.Name):
        return node.id in sleep_names
    return False


@rule("res-sleep",
      "no time.sleep outside resilience/retry.py — one wait chokepoint")
def check_sleep(ctx: FileContext):
    if ctx.path in {os.path.normpath(p) for p in SLEEP_ALLOWED}:
        return
    time_aliases = ctx.module_aliases("time")
    sleep_names = ctx.from_aliases("time", "sleep")
    for node in ctx.walk():
        if _is_time_sleep(node, time_aliases, sleep_names):
            yield ctx.finding(
                "res-sleep", node,
                "time.sleep outside resilience/retry.py — route waits "
                "through the retry module so deadlines and the watchdog "
                "see them")


def _is_part_file_write(node: ast.AST) -> bool:
    """True for ``open(..)`` / ``write_avro_file(..)`` calls whose argument
    tree contains a ``part-*.avro`` string literal (the model part-file
    naming contract — ``os.path.join(..., "part-00000.avro")`` included)."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None)
    if name not in ("open", "write_avro_file"):
        return False
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and "part-" in sub.value and sub.value.endswith(".avro")):
            # reads are fine: only flag an explicit write mode / the writer
            if name == "write_avro_file":
                return True
            mode = None
            if len(node.args) > 1 and isinstance(node.args[1], ast.Constant):
                mode = node.args[1].value
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = kw.value.value
            return isinstance(mode, str) and ("w" in mode or "a" in mode
                                              or "x" in mode)
    return False


@rule("res-part-write",
      "no model part-file writes outside io/ — atomic staged publish only")
def check_part_write(ctx: FileContext):
    if ctx.path.startswith(PART_WRITE_ALLOWED_PREFIX):
        return
    for node in ctx.walk():
        if _is_part_file_write(node):
            yield ctx.finding(
                "res-part-write", node,
                "model part-file write outside io/ — a bare part-*.avro "
                "write bypasses the atomic staged publish; route through "
                "io.model_io.save_game_model / io.pipeline.BackgroundSaver")


def _is_process_call(node: ast.AST, subprocess_aliases: set[str],
                     os_aliases: set[str], popen_names: set[str],
                     kill_names: set[str]) -> bool:
    """True for ``subprocess.Popen(..)`` / ``os.kill``/``os.killpg`` calls
    (module- and from-import aliases included)."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        if fn.attr == "Popen" and fn.value.id in subprocess_aliases:
            return True
        if fn.attr in ("kill", "killpg") and fn.value.id in os_aliases:
            return True
    if isinstance(fn, ast.Name):
        return fn.id in popen_names or fn.id in kill_names
    return False


@rule("res-process",
      "no subprocess.Popen/os.kill outside resilience/supervisor.py")
def check_process(ctx: FileContext):
    if ctx.path in {os.path.normpath(p) for p in PROCESS_ALLOWED}:
        return
    subprocess_aliases = ctx.module_aliases("subprocess")
    os_aliases = ctx.module_aliases("os")
    popen_names = ctx.from_aliases("subprocess", "Popen")
    kill_names = ctx.from_aliases("os", "kill", "killpg")
    for node in ctx.walk():
        if _is_process_call(node, subprocess_aliases, os_aliases,
                            popen_names, kill_names):
            yield ctx.finding(
                "res-process", node,
                "subprocess.Popen/os.kill outside resilience/supervisor.py "
                "— process lifecycle must stay visible to the fleet "
                "supervisor (an untracked child survives _kill_fleet or "
                "dies without a liveness signal); route process management "
                "through FleetSupervisor")


def _is_table_attr(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "table"


def _contains_table_attr(node: ast.AST) -> bool:
    return any(_is_table_attr(sub) for sub in ast.walk(node))


def _store_table_writes(tree: ast.AST) -> list[ast.AST]:
    """Nodes mutating/deriving a serving ``.table``: subscript or attribute
    assignment targets over ``<expr>.table``, and functional
    ``<expr>.table.at[...]`` updates."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if _is_table_attr(t):
                    out.append(t)
                elif isinstance(t, ast.Subscript) and _is_table_attr(t.value):
                    out.append(t)
        elif (isinstance(node, ast.Attribute) and node.attr == "at"
              and _is_table_attr(node.value)):
            out.append(node)
    return out


def _store_table_quant(tree: ast.AST) -> list[ast.AST]:
    """Quantization half of the table rule: an ``.astype(...)`` cast whose
    receiver involves ``.table``, or a ``*`` / ``/`` arithmetic expression
    with a ``.table`` operand (a scale multiply/divide) — either is an
    ad-hoc quantize/dequantize outside the store's one sanctioned format
    home (``quantize_rows`` / ``gather_rows``)."""
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "astype"
                and _contains_table_attr(node.func.value)):
            out.append(node)
        elif (isinstance(node, ast.BinOp)
              and isinstance(node.op, (ast.Mult, ast.Div))
              and (_contains_table_attr(node.left)
                   or _contains_table_attr(node.right))):
            out.append(node)
    return out


@rule("res-table-home",
      "serving coefficient-table writes and quantize/dequantize math stay "
      "in serving/store.py")
def check_table_home(ctx: FileContext):
    if ctx.path in {os.path.normpath(p) for p in STORE_ALLOWED}:
        return
    for node in _store_table_writes(ctx.tree):
        yield ctx.finding(
            "res-table-home", node,
            "serving coefficient-table write outside serving/store.py — "
            "version tables are immutable (hot-swap/rollback and the "
            "delta path depend on it); derive new tables through "
            "EntityCoefficientStore.build/apply_patch")
    for node in _store_table_quant(ctx.tree):
        yield ctx.finding(
            "res-table-home", node,
            "quantize/dequantize of a serving .table array outside "
            "serving/store.py — table storage format (dtype + per-row "
            "scales) is a store.py-private contract; read rows through "
            "store.gather_rows / device_params")


#: the one module allowed to call crc32 (it owns identity bucketing:
#: entity→shard placement, request-log sampling, probe selection, fault
#: seeding all derive from its one hash)
SHARD_HOME = {os.path.join("photon_ml_tpu_torch", "fleet", "sharding.py")}

#: crc32 over raw BYTES for Avro container integrity is a checksum, not
#: an identity bucket — the codec keeps its own call
SHARD_EXEMPT = {os.path.join("photon_ml_tpu_torch", "io", "avro.py")}


def _is_crc32_call(node: ast.AST, zlib_aliases: set[str],
                   binascii_aliases: set[str],
                   crc_names: set[str]) -> bool:
    """True for ``crc32(..)`` calls of ``zlib`` or ``binascii``
    (module- and from-import aliases included)."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr == "crc32":
        return (isinstance(fn.value, ast.Name)
                and fn.value.id in zlib_aliases | binascii_aliases)
    if isinstance(fn, ast.Name):
        return fn.id in crc_names
    return False


#: the virtual-bucket count (``fleet.sharding.N_BUCKETS``); a literal
#: ``% 4096`` outside the home is ad-hoc bucket math
_N_BUCKETS_LITERAL = 4096


def _is_bucket_mod(node: ast.AST, bucket_names: set[str],
                   sharding_aliases: set[str]) -> bool:
    """True for a ``<expr> % 4096`` / ``<expr> % N_BUCKETS`` modulo — the
    virtual-bucket half of the placement hash recomputed outside the home
    (``N_BUCKETS`` matched via its from-import alias or as an attribute of
    an imported ``fleet.sharding`` module alias)."""
    if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod)):
        return False
    right = node.right
    if (isinstance(right, ast.Constant)
            and right.value == _N_BUCKETS_LITERAL):
        return True
    if isinstance(right, ast.Name) and right.id in bucket_names:
        return True
    return (isinstance(right, ast.Attribute)
            and right.attr == "N_BUCKETS"
            and isinstance(right.value, ast.Name)
            and right.value.id in sharding_aliases)


@rule("res-shard-home",
      "entity→shard hashing primitives (crc32 + virtual-bucket math) stay "
      "in fleet/sharding.py")
def check_shard_home(ctx: FileContext):
    if ctx.path in {os.path.normpath(p) for p in SHARD_HOME | SHARD_EXEMPT}:
        return
    zlib_aliases = ctx.module_aliases("zlib")
    binascii_aliases = ctx.module_aliases("binascii")
    crc_names = (ctx.from_aliases("zlib", "crc32")
                 | ctx.from_aliases("binascii", "crc32"))
    bucket_names = ctx.from_aliases("photon_ml_tpu_torch.fleet.sharding",
                                    "N_BUCKETS")
    sharding_aliases = ctx.module_aliases("photon_ml_tpu_torch.fleet.sharding")
    for node in ctx.walk():
        if _is_crc32_call(node, zlib_aliases, binascii_aliases, crc_names):
            yield ctx.finding(
                "res-shard-home", node,
                "crc32 call outside fleet/sharding.py — identity "
                "bucketing (entity→shard placement, id sampling) must "
                "come from the one hashing home or two components can "
                "silently disagree on which host owns an id; call "
                "fleet.sharding.shard_of_id/crc_bucket/stable_hash_u32")
        elif _is_bucket_mod(node, bucket_names, sharding_aliases):
            yield ctx.finding(
                "res-shard-home", node,
                "virtual-bucket modulo outside fleet/sharding.py — "
                "bucket→shard placement goes through the versioned "
                "ShardMap (id → bucket → shard); recomputing "
                "`% N_BUCKETS` elsewhere silently disagrees with a "
                "resharded map; call fleet.sharding.bucket_of_id/"
                "ShardMap.shard_of")


#: serving/ — the one package where every queue must be bounded (the
#: admission-control contract: overload sheds loudly, it never queues
#: forever)
SERVING_PREFIX = os.path.join("photon_ml_tpu_torch", "serving") + os.sep


def _const_zero(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant)
            and isinstance(node.value, int) and node.value == 0)


def _has_bound(node: ast.Call, kwarg: str, pos: int) -> bool:
    """Does this constructor call carry a bound — ``kwarg=`` (non-zero
    when a constant) or a positional argument at ``pos``?"""
    for kw in node.keywords:
        if kw.arg == kwarg:
            return not _const_zero(kw.value)
    if len(node.args) > pos:
        return not _const_zero(node.args[pos])
    return False


def _fifo_attrs(tree: ast.AST) -> set[str]:
    """``self.<attr>`` names used FIFO-style: ``.pop(0)`` or
    ``.insert(0, ...)`` — a plain list serving as a queue."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        recv = node.func.value
        if not (isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"):
            continue
        if (node.func.attr in ("pop", "insert") and node.args
                and _const_zero(node.args[0])):
            out.add(recv.attr)
    return out


@rule("res-bounded-queue",
      "no unbounded deque()/queue.Queue()/list-as-queue construction "
      "inside serving/ — overload must shed, not queue forever")
def check_bounded_queue(ctx: FileContext):
    if not ctx.path.startswith(SERVING_PREFIX):
        return
    deque_names = ctx.from_aliases("collections", "deque")
    collections_aliases = ctx.module_aliases("collections")
    queue_cls_names = ctx.from_aliases("queue", "Queue", "LifoQueue",
                                       "PriorityQueue")
    simple_names = ctx.from_aliases("queue", "SimpleQueue")
    queue_aliases = ctx.module_aliases("queue")
    fifo = _fifo_attrs(ctx.tree)
    for node in ctx.walk():
        if isinstance(node, ast.Call):
            fn = node.func
            is_deque = (
                (isinstance(fn, ast.Name) and fn.id in deque_names)
                or (isinstance(fn, ast.Attribute) and fn.attr == "deque"
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in collections_aliases))
            is_queue = (
                (isinstance(fn, ast.Name)
                 and fn.id in queue_cls_names)
                or (isinstance(fn, ast.Attribute)
                    and fn.attr in ("Queue", "LifoQueue", "PriorityQueue")
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in queue_aliases))
            is_simple = (
                (isinstance(fn, ast.Name) and fn.id in simple_names)
                or (isinstance(fn, ast.Attribute)
                    and fn.attr == "SimpleQueue"
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in queue_aliases))
            if is_deque and not _has_bound(node, "maxlen", 1):
                yield ctx.finding(
                    "res-bounded-queue", node,
                    "unbounded deque() in serving/ — a request queue with "
                    "no bound degrades overload into unbounded latency; "
                    "pass maxlen= or justify the explicit admission check "
                    "with a suppression")
            elif is_queue and not _has_bound(node, "maxsize", 0):
                yield ctx.finding(
                    "res-bounded-queue", node,
                    "unbounded queue.Queue() in serving/ — pass a "
                    "positive maxsize (or justify with a suppression)")
            elif is_simple:
                yield ctx.finding(
                    "res-bounded-queue", node,
                    "queue.SimpleQueue() in serving/ has no capacity "
                    "bound at all — use queue.Queue(maxsize=N)")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            value = node.value
            is_empty_list = (isinstance(value, ast.List) and not value.elts
                             ) or (isinstance(value, ast.Call)
                                   and isinstance(value.func, ast.Name)
                                   and value.func.id == "list"
                                   and not value.args and not value.keywords)
            if not is_empty_list:
                continue
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self" and t.attr in fifo):
                    yield ctx.finding(
                        "res-bounded-queue", t,
                        f"list-as-queue in serving/: self.{t.attr} is "
                        f"drained with pop(0)/insert(0, ..) but "
                        f"constructed with no bound — bound it or "
                        f"justify the bounding logic with a suppression")


#: the sanctioned request-log READ paths: the feedback joiner (the one
#: label-join surface); reqlog.py itself owns the reader it exports
REQLOG_READ_ALLOWED = {
    os.path.join("photon_ml_tpu_torch", "serving", "reqlog.py"),
    os.path.join("photon_ml_tpu_torch", "feedback", "joiner.py"),
}


def _is_iter_reqlog_call(node: ast.AST, reader_names: set[str],
                         reqlog_aliases: set[str]) -> bool:
    """True for ``iter_reqlog(..)`` calls — by imported name or as an
    attribute on an alias of the reqlog (or serving) module."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Name) and f.id in reader_names:
        return True
    return (isinstance(f, ast.Attribute) and f.attr == "iter_reqlog"
            and isinstance(f.value, ast.Name)
            and f.value.id in reqlog_aliases)


@rule("res-reqlog-read-home",
      "request-log READS stay in feedback/joiner.py", scope="all")
def check_reqlog_read_home(ctx: FileContext):
    if ctx.path in {os.path.normpath(p) for p in REQLOG_READ_ALLOWED}:
        return
    reader_names = (
        ctx.from_aliases("photon_ml_tpu_torch.serving.reqlog", "iter_reqlog")
        | ctx.from_aliases("photon_ml_tpu_torch.serving", "iter_reqlog"))
    reqlog_aliases = (
        ctx.module_aliases("photon_ml_tpu_torch.serving.reqlog")
        | ctx.module_aliases("photon_ml_tpu_torch.serving"))
    for node in ctx.walk():
        if _is_iter_reqlog_call(node, reader_names, reqlog_aliases):
            yield ctx.finding(
                "res-reqlog-read-home", node,
                "iter_reqlog call outside the sanctioned read path — "
                "the log's schema, segment order and join/duplicate "
                "semantics are one contract owned by feedback/joiner.py "
                "(training joins); a second reader silently forks that "
                "contract. Join through feedback.join_feedback instead")
