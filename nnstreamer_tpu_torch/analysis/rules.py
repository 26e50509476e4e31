"""The project-specific rule catalog of the port (the JAX package's
analysis/rules.py; the rules that named jax take a torch form, ROADMAP
N42).

NNL001 element-contract   timer pair complete; CHAIN_FUSABLE matches
                          element shape; DEVICE_RESIDENT not on sinks;
                          contract flags declared, not mutated per-instance
NNL002 forced-sync        .item() / .tolist() / .cpu() / a device, event
                          or stream synchronize(), and a bare np.asarray
                          in backends/ and runtime/, only via
                          runtime/sync.device_sync
NNL003 lock-discipline    no blocking call inside a `with <lock>:` body
NNL004 jit-purity         nothing impure reachable from a body captured
                          into a CUDA graph (backends/cuda_graphs.capture,
                          GraphCache.capture: the port's compiled
                          program) or composed into a segment
NNL005 spawn-safety       no module-scope CUDA work in modules the spawn
                          worker imports
NNL006 picklable-errors   every public error class carries the
                          __reduce__ round-trip contract
NNL007 thread-audit       every thread is daemon or joined/cancelled on
                          a close path
NNL008 socket-audit       every socket in the serving path has a
                          deadline (timeout kwarg / settimeout) or is
                          owned by a reader/accept thread
NNL009 placement-audit    constant-index device picks (cuda:<int>,
                          torch.device("cuda", <int>), set_device(<int>),
                          .cuda(<int>)) only inside serving/placement.py
                          and parallel/
NNL010 device-accounting  CUDA memory ledgers (memory_stats(),
                          memory_allocated(), mem_get_info(), ...),
                          FlopCounterMode and peak-FLOPs/bandwidth tables
                          only inside runtime/devprof.py — one accounting
                          site for "peak" vs "achieved"
NNL011 seeded-chaos       no unseeded RNG construction
                          (random.Random() / np.random.default_rng()
                          with no arguments) in the chaos/load paths
                          (traffic/, scenario/, serving worker chaos
                          hooks) — every drill must replay bit-exact
                          from its recorded seed
NNL012 shard-safety       torch.distributed collectives and process
                          groups, DeviceMesh / distribute_tensor only
                          inside parallel/ and serving/sharding.py
NNL013 shm-safety         multiprocessing.shared_memory / mmap only
                          inside serving/shm.py, and no per-frame
                          `pickle.dumps` inside loops on the serving hot
                          paths

Every rule is pure AST — nothing here imports the code under analysis.
Heuristics err toward silence (a missed finding is a review problem; a
noisy gate gets deleted), and every deliberate exception at a flagged
site takes an inline `# nnlint: disable=...` with a justification.
NNL001, NNL003, NNL006-NNL008, NNL011 and NNL013 are the JAX package's
rules as they stand: on the same sources they give its findings, with
the same fingerprints.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from nnstreamer_tpu_torch.analysis.core import (
    Module, Project, Rule, const_value, dotted, walk_no_functions)

#: class names that mark an Element subclass without importing it
_ELEMENT_BASES = {"Element", "SourceElement", "SinkElement"}
#: sink-side bases (sync points: DEVICE_RESIDENT is a contradiction)
_SINK_BASES = {"SinkElement"}


def _is_element_class(node: ast.ClassDef) -> bool:
    for deco in node.decorator_list:
        if dotted(deco).split(".")[-1] == "register_element":
            return True
    return any(dotted(b).split(".")[-1] in _ELEMENT_BASES
               for b in node.bases)


def _class_assigns(node: ast.ClassDef) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for stmt in node.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                and isinstance(stmt.target, ast.Name):
            out[stmt.target.id] = stmt.value
    return out


def _method_names(node: ast.ClassDef) -> Set[str]:
    return {s.name for s in node.body
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}


class ElementContract(Rule):
    rule_id = "NNL001"
    title = "element-contract"
    rationale = (
        "the scheduler trusts class-level contract flags: a timer "
        "element missing half its pair never wakes (or fires into a "
        "missing handler), a fusable multi-pad element would execute "
        "fan-in on a chain thread, and a DEVICE_RESIDENT sink would "
        "never sync its results")

    def check(self, module: Module, project: Project):
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef) and _is_element_class(node):
                yield from self._check_class(node)
            # contract flags are class-level declarations the scheduler
            # and docs introspect — per-instance mutation hides them
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self" \
                            and t.attr in ("CHAIN_FUSABLE",
                                           "DEVICE_RESIDENT"):
                        yield node, (
                            f"contract flag {t.attr} mutated per-instance; "
                            f"declare it on the class (the scheduler and "
                            f"docs introspect the class-level value)")

    def _check_class(self, node: ast.ClassDef):
        assigns = _class_assigns(node)
        methods = _method_names(node)
        has_deadline = "next_deadline" in methods
        has_timer = "on_timer" in methods
        if has_deadline != has_timer:
            missing = "on_timer" if has_deadline else "next_deadline"
            present = "next_deadline" if has_deadline else "on_timer"
            yield node, (
                f"element {node.name} defines {present} without "
                f"{missing}: the timer contract is a pair (scheduler "
                f"worker loop fires on_timer when next_deadline expires)")
        fusable = const_value(assigns["CHAIN_FUSABLE"]) \
            if "CHAIN_FUSABLE" in assigns else None
        if (has_deadline and has_timer) and fusable is not False:
            yield node, (
                f"timer element {node.name} must declare CHAIN_FUSABLE "
                f"= False: a fused chain member cannot be woken "
                f"independently of its chain head")
        for attr in ("NUM_SINK_PADS", "NUM_SRC_PADS"):
            if attr in assigns:
                v = const_value(assigns[attr])
                if isinstance(v, int) and (v == -1 or v >= 2) \
                        and fusable is not False:
                    yield node, (
                        f"element {node.name} declares {attr}="
                        f"{'DYNAMIC' if v == -1 else v} but not "
                        f"CHAIN_FUSABLE = False: chain fusion is for "
                        f"single-in/single-out call-through elements only")
                    break
        if const_value(assigns.get("DEVICE_RESIDENT",
                                   ast.Constant(False))) is True:
            if any(dotted(b).split(".")[-1] in _SINK_BASES
                   for b in node.bases):
                yield node, (
                    f"sink element {node.name} declares DEVICE_RESIDENT "
                    f"= True: sinks are sync points — their results "
                    f"must resolve (runtime/sync.device_sync)")


class ForcedSync(Rule):
    rule_id = "NNL002"
    title = "forced-sync"
    rationale = (
        "runtime/sync.device_sync is the single host-sync choke point: "
        "it waits on each device's stream once and feeds the tracer's "
        "forced_syncs stat — a direct .item() / .tolist() / .cpu(), a "
        "torch.cuda / event / stream synchronize() or a device-tensor "
        "np.asarray elsewhere is an invisible host-path tax the bench can "
        "no longer attribute")

    #: the one module allowed to touch the primitives
    EXEMPT = ("runtime/sync.py",)
    #: directories where a bare single-arg np.asarray is presumed to be
    #: a device readback (elements/decoders consume host arrays the
    #: scheduler already resolved; the device-adjacent layers do not).
    #: Deliberately NOT listed: serving/ — the metrics/exposition plane
    #: (serving/metrics.py) and the pool router are host-only code that
    #: read counters under their own locks and never hold a device
    #: tensor, so a bare asarray there is a plain host copy, not a
    #: hidden sync. Widening this to serving/ would force the blessed
    #: device_sync idiom onto code with no device to sync.
    ASARRAY_DIRS = ("backends/", "runtime/")
    #: tensor methods that wait for the device and copy to the host
    READBACKS = ("item", "tolist", "cpu")

    def check(self, module: Module, project: Project):
        if module.path.endswith(self.EXEMPT):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            leaf = d.split(".")[-1]
            if leaf == "synchronize" and isinstance(node.func,
                                                    ast.Attribute):
                yield node, (
                    f"direct {d or leaf}() bypasses "
                    f"runtime/sync.device_sync (one sync call site keeps "
                    f"the tracer's forced_syncs truthful)")
            elif leaf in self.READBACKS and isinstance(node.func,
                                                       ast.Attribute) \
                    and not node.args and not node.keywords \
                    and not _numpy_value(node.func.value):
                yield node, (
                    f".{leaf}() is a hidden host sync on a device tensor; "
                    f"read back through runtime/sync.to_host (or "
                    f"device_sync, then read) so the sync is counted, or "
                    f"add a justification")
            elif d in ("np.asarray", "numpy.asarray") \
                    and self._in_asarray_scope(module.path) \
                    and len(node.args) == 1 and not node.keywords \
                    and not self._arg_is_synced(node.args[0]):
                yield node, (
                    "bare np.asarray in a device-adjacent layer is a "
                    "hidden host sync; use np.asarray(device_sync(x)) "
                    "so the sync is counted, or add a justification")

    def _in_asarray_scope(self, path: str) -> bool:
        return any(f"/{d}" in f"/{path}" for d in self.ASARRAY_DIRS)

    @staticmethod
    def _arg_is_synced(arg: ast.AST) -> bool:
        """np.asarray(device_sync(x)) is the blessed idiom: the sync is
        explicit and counted; the asarray is then a plain host copy."""
        return isinstance(arg, ast.Call) \
            and dotted(arg.func).split(".")[-1] == "device_sync"


def _numpy_value(node: ast.AST) -> bool:
    """The expression is evidently a numpy value: the call it indexes,
    or whose method it calls, is an ``np.``/``numpy.`` function
    (``np.cumsum(v)[:-1].tolist()``). Anything else may be a tensor."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            if dotted(node.func).startswith(("np.", "numpy.")):
                return True
            node = node.func
        elif isinstance(node, ast.Attribute):
            node = node.value
        else:
            return False


class LockDiscipline(Rule):
    rule_id = "NNL003"
    title = "lock-discipline"
    rationale = (
        "a blocking call while holding a lock is the classic deadlock/"
        "latency-cliff shape: every other thread that needs the lock "
        "stalls behind the wait (runtime/channel.py exists to do this "
        "correctly with condition variables)")

    #: queue-ish receiver names where a positional .get()/.put() is a
    #: blocking channel operation, not a dict access
    QUEUE_NAMES = {"q", "queue", "outq", "inq", "sendq", "frames",
                   "channel", "chan", "done_q", "acks"}

    def check(self, module: Module, project: Project):
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.With):
                continue
            lock_names = [dotted(item.context_expr).split(".")[-1]
                          for item in node.items]
            if not any(n.lower().endswith("lock") for n in lock_names):
                continue
            for inner in walk_no_functions(node.body):
                if isinstance(inner, ast.Call):
                    msg = self._blocking(inner)
                    if msg:
                        yield inner, (
                            f"{msg} inside `with "
                            f"{'/'.join(lock_names)}:` — blocking under "
                            f"a lock stalls every thread that needs it")

    def _blocking(self, call: ast.Call) -> Optional[str]:
        d = dotted(call.func)
        leaf = d.split(".")[-1]
        kwargs = {k.arg for k in call.keywords}
        if d == "time.sleep" or leaf == "sleep":
            return "time.sleep"
        if leaf == "device_sync":
            return "device_sync (host sync)"
        if leaf == "join" and (not call.args or "timeout" in kwargs):
            # str.join always takes one positional and never timeout=
            return "thread/process join"
        if leaf in ("recv", "recv_bytes", "accept", "recvfrom"):
            return f"socket/pipe {leaf}()"
        if leaf in ("get", "put"):
            recv = dotted(call.func.value).split(".")[-1].lower() \
                .lstrip("_") if isinstance(call.func, ast.Attribute) else ""
            if kwargs & {"timeout", "deadline"} \
                    or recv in self.QUEUE_NAMES:
                return f"queue/channel {leaf}()"
        return None


#: call prefixes/names that are impure in a captured body: host clocks,
#: host RNG, I/O, logging, tracer hooks, host syncs and read-backs
_CAPTURE_BANNED_PREFIX = ("time.", "random.", "np.random.", "numpy.random.",
                          "os.", "socket.", "logging.")
_CAPTURE_BANNED_NAMES = {"open", "print", "input", "perf_counter",
                         "device_sync", "to_host", "monotonic"}
#: attribute calls that wait for the device or read a tensor back
_CAPTURE_BANNED_LEAVES = {"synchronize", "item", "tolist", "cpu"}
#: module origins that make a bare imported name impure
_CAPTURE_BANNED_MODULES = {"time", "random", "os", "socket"}


class CapturePurity(Rule):
    rule_id = "NNL004"
    title = "jit-purity"
    rationale = (
        "a body captured into a CUDA graph (backends/cuda_graphs.capture, "
        "GraphCache.capture) runs its Python ONCE, at capture: every "
        "replay re-launches the recorded kernels and nothing else, so a "
        "host clock freezes into the first window's value, a host RNG "
        "draw or a tracer/I-O call fires once instead of per window, and "
        "a device_sync / .item() inside the capture either fails it or "
        "reads a value that no replay refreshes — all silent "
        "wrong-answer bugs")

    MAX_DEPTH = 8

    def check(self, module: Module, project: Project):
        imports = None     # built at the module's first capture entry
        for node in ast.walk(module.tree):
            fn: Optional[Tuple[Module, ast.AST]] = None
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for deco in node.decorator_list:
                    if dotted(deco).split(".")[-1] == "compose_segment":
                        fn = (module, node)
            elif isinstance(node, ast.Call):
                body = self._captured_body(node)
                if body is not None:
                    if imports is None:
                        imports = _import_map(module.tree)
                    fn = self._resolve(module, project, imports, body)
            if fn is None:
                continue
            seen: Set[Tuple[str, str]] = set()
            yield from self._scan(project, fn[0], fn[1], seen, 0)

    @staticmethod
    def _captured_body(call: ast.Call) -> Optional[ast.AST]:
        """The body argument of a capture entry: ``capture(body, inputs,
        ...)`` (the module function, bare or as ``cuda_graphs.capture``),
        ``<cache>.capture(key, body, inputs, ...)`` (a GraphCache), or
        ``compose_segment(fn)``; ``body=`` by keyword too."""
        d = dotted(call.func)
        leaf = d.split(".")[-1]
        for k in call.keywords:
            if k.arg == "body" and leaf == "capture":
                return k.value
        if leaf == "compose_segment" or d in ("capture",
                                              "cuda_graphs.capture"):
            return call.args[0] if call.args else None
        if leaf == "capture" and isinstance(call.func, ast.Attribute) \
                and len(call.args) >= 2:
            return call.args[1]
        return None

    def _resolve(self, module: Module, project: Project, imports,
                 arg: ast.AST) -> Optional[Tuple[Module, ast.AST]]:
        """Name → its FunctionDef, locally or via `from X import f`
        when X is a scanned module. Lambdas/inline defs analyze in
        place; attributes (bound methods) are skipped."""
        if isinstance(arg, ast.Lambda):
            return module, arg
        if not isinstance(arg, ast.Name):
            return None
        fn = _module_function(module.tree, arg.id)
        if fn is not None:
            return module, fn
        origin = imports.get(arg.id)
        if origin:
            target = project.by_dotted(origin[0])
            if target is not None:
                fn = _module_function(target.tree, origin[1])
                if fn is not None:
                    return target, fn
        return None

    def _scan(self, project: Project, module: Module, fn: ast.AST,
              seen: Set[Tuple[str, str]], depth: int):
        key = (module.path, getattr(fn, "name", f"<lambda@{fn.lineno}>"))
        if key in seen or depth > self.MAX_DEPTH:
            return
        seen.add(key)
        imports = _import_map(module.tree)
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for node in ast.walk(ast.Module(body=body, type_ignores=[])):
            if isinstance(node, ast.Attribute) and node.attr == "_tracer":
                yield _at(node, module, fn), (
                    f"tracer access reachable from captured "
                    f"{key[1]} ({module.path}): hooks fire at capture, "
                    f"not per replay")
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            leaf = d.split(".")[-1]
            banned = (
                any(d.startswith(p) for p in _CAPTURE_BANNED_PREFIX)
                or d in _CAPTURE_BANNED_NAMES
                or (isinstance(node.func, ast.Attribute)
                    and leaf in _CAPTURE_BANNED_LEAVES
                    and not node.args)
                or (isinstance(node.func, ast.Name)
                    and imports.get(d, ("",))[0] in _CAPTURE_BANNED_MODULES))
            if banned:
                yield _at(node, module, fn), (
                    f"impure call {d or leaf}() reachable from captured "
                    f"{key[1]} ({module.path}): runs once at capture, "
                    f"never at replay")
                continue
            # follow local/imported plain-function calls
            nxt = self._resolve(module, project, imports,
                                node.func if isinstance(node.func, ast.Name)
                                else ast.Constant(None))
            if nxt is not None:
                yield from self._scan(project, nxt[0], nxt[1], seen,
                                      depth + 1)


def _at(node: ast.AST, module: Module, fn: ast.AST):
    """Findings for cross-module reachability anchor on the defining
    module only when it is the one being scanned; otherwise on the
    captured function's def line (suppressions stay local)."""
    return node if getattr(node, "lineno", None) else fn


def _module_function(tree: ast.AST, name: str) -> Optional[ast.AST]:
    """FunctionDef named `name` anywhere in the module (captured bodies
    are often defined inside the function that captures them)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _import_map(tree: ast.AST) -> Dict[str, Tuple[str, str]]:
    """name → (module dotted path, original name) for every import in
    the tree (function-local imports included: the runtime imports
    heavy modules lazily everywhere)."""
    out: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[(a.asname or a.name).split(".")[0]] = (a.name, "")
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if a.name != "*":
                    out[a.asname or a.name] = (node.module, a.name)
    return out


class SpawnSafety(Rule):
    rule_id = "NNL005"
    title = "spawn-safety"
    rationale = (
        "serving/pool.py uses the spawn context: every worker process "
        "re-imports its modules from scratch — module-scope CUDA work in "
        "that closure (a torch.cuda call, a .cuda() copy, a tensor built "
        "on a CUDA device) creates the CUDA context at import, N times, "
        "before the worker caps its allocator (serving/worker.py, "
        "ROADMAP N24), and wedges startup. A module-scope `import torch` "
        "touches no device and is fine")

    ROOT = "nnstreamer_tpu_torch/serving/worker.py"
    PKG = "nnstreamer_tpu_torch"

    def check(self, module: Module, project: Project):
        closure = self._closure(project)
        if module.path not in closure:
            return
        for stmt in self._module_scope(module.tree):
            if isinstance(stmt, (ast.Import, ast.ImportFrom)):
                continue
            for node in walk_no_functions([stmt]):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted(node.func)
                if d.startswith("torch.cuda.") \
                        or d.split(".")[-1] == "cuda" \
                        or _cuda_device_kw(node):
                    yield node, (
                        f"module-scope device work {d or 'call'}() in a "
                        f"module the spawn worker imports ({self.ROOT}): "
                        f"every worker re-runs it at import, before it "
                        f"caps its allocator")

    def _closure(self, project: Project) -> Set[str]:
        root = project.modules.get(self.ROOT)
        if root is None:
            return set()
        todo, seen = [self.ROOT], {self.ROOT}
        while todo:
            mod = project.modules.get(todo.pop())
            if mod is None:
                continue
            for stmt in self._module_scope(mod.tree):
                for name in self._imported_modules(stmt, mod.path):
                    if not name.startswith(self.PKG):
                        continue
                    target = project.by_dotted(name)
                    if target and target.path not in seen:
                        seen.add(target.path)
                        todo.append(target.path)
        return seen

    @staticmethod
    def _module_scope(tree: ast.AST):
        """Top-level statements, descending through top-level if/try
        blocks (conditional imports still run at import time) but never
        into function or class bodies' functions."""
        stack = list(getattr(tree, "body", []))
        while stack:
            stmt = stack.pop()
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, (ast.If, ast.Try, ast.With, ast.ClassDef)):
                for field in ("body", "orelse", "finalbody"):
                    stack.extend(getattr(stmt, field, []))
                for h in getattr(stmt, "handlers", []):
                    stack.extend(h.body)
                continue
            yield stmt

    @staticmethod
    def _imported_modules(stmt: ast.AST, path: str) -> Iterable[str]:
        if isinstance(stmt, ast.Import):
            for a in stmt.names:
                yield a.name
        elif isinstance(stmt, ast.ImportFrom):
            if stmt.level:
                pkg_parts = path.split("/")[:-1]
                base = ".".join(pkg_parts[: len(pkg_parts) - stmt.level + 1])
                mod = f"{base}.{stmt.module}" if stmt.module else base
            else:
                mod = stmt.module or ""
            # `from X import name`: name may be a submodule or an
            # attribute — offer both; by_dotted misses attributes
            yield mod
            for a in stmt.names:
                if a.name != "*":
                    yield f"{mod}.{a.name}"


class PicklableErrors(Rule):
    rule_id = "NNL006"
    title = "picklable-errors"
    rationale = (
        "errors cross process boundaries in the worker pool pickled; "
        "naive pickling re-invokes cls(*args), so any subclass with a "
        "custom __init__ signature raises TypeError at UNPICKLE time — "
        "the parent then loses the real failure")

    def check(self, module: Module, project: Project):
        if not module.path.endswith("errors.py"):
            return
        classes: Dict[str, ast.ClassDef] = {
            n.name: n for n in module.tree.body
            if isinstance(n, ast.ClassDef)}
        for node in classes.values():
            if node.name.startswith("_"):
                continue
            if not self._is_exception(node, classes):
                continue
            if not self._has_reduce(node, classes):
                yield node, (
                    f"public error class {node.name} has no __reduce__ "
                    f"in its local base chain: subclass "
                    f"NNStreamerTPUError (or define __reduce__) so it "
                    f"survives the worker-pool pickle round trip")

    def _is_exception(self, node: ast.ClassDef,
                      classes: Dict[str, ast.ClassDef]) -> bool:
        for b in node.bases:
            name = dotted(b).split(".")[-1]
            if name in ("Exception", "BaseException") \
                    or name.endswith("Error"):
                if name in classes:
                    return self._is_exception(classes[name], classes) \
                        or True
                return True
            if name in classes and self._is_exception(classes[name],
                                                      classes):
                return True
        return False

    def _has_reduce(self, node: ast.ClassDef,
                    classes: Dict[str, ast.ClassDef],
                    depth: int = 0) -> bool:
        if depth > 10:
            return False
        if "__reduce__" in _method_names(node):
            return True
        return any(self._has_reduce(classes[dotted(b).split(".")[-1]],
                                    classes, depth + 1)
                   for b in node.bases
                   if dotted(b).split(".")[-1] in classes)


class ThreadAudit(Rule):
    rule_id = "NNL007"
    title = "thread-audit"
    rationale = (
        "a non-daemon thread that nobody joins outlives its owner: "
        "teardown hangs waiting for it (a fired Timer held a worker "
        "process alive past its graceful exit), and tests leak "
        "threads across cases")

    def check(self, module: Module, project: Project):
        src = module.src
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_subclass(node)
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            leaf = d.split(".")[-1]
            if d not in ("threading.Thread", "threading.Timer") \
                    and leaf not in ("Thread", "Timer"):
                continue
            if leaf not in ("Thread", "Timer"):
                continue
            if not (d.startswith("threading.") or d in ("Thread", "Timer")):
                continue
            if self._daemon_kw(node):
                continue
            target = self._assign_target(module, node)
            if target and (f"{target}.join" in src
                           or f"{target}.cancel" in src
                           or f"{target}.daemon" in src):
                continue
            kind = "Timer" if leaf == "Timer" else "Thread"
            yield node, (
                f"threading.{kind} is neither daemon=True nor "
                f"joined/cancelled on a close path: it outlives its "
                f"owner and hangs teardown")

    @staticmethod
    def _daemon_kw(node: ast.Call) -> bool:
        for k in node.keywords:
            if k.arg == "daemon" \
                    and isinstance(k.value, ast.Constant) \
                    and k.value.value is True:
                return True
        return False

    @staticmethod
    def _assign_target(module: Module, call: ast.Call) -> Optional[str]:
        """Terminal name the Thread lands in (x / self.x / slot.x),
        found by locating the Assign/append wrapping this call."""
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) and node.value is call:
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    return t.id
                if isinstance(t, ast.Attribute):
                    return t.attr
            # timers.append(threading.Timer(...)) — audit the list name
            if isinstance(node, ast.Call) and call in node.args \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "append":
                return dotted(node.func.value).split(".")[-1]
        return None

    def _check_subclass(self, node: ast.ClassDef):
        if not any(dotted(b) in ("threading.Thread", "Thread")
                   for b in node.bases):
            return
        for stmt in node.body:
            if isinstance(stmt, ast.FunctionDef) \
                    and stmt.name == "__init__":
                blob = ast.dump(stmt)
                if "daemon" in blob:
                    return
                yield node, (
                    f"threading.Thread subclass {node.name}.__init__ "
                    f"never sets daemon: instances default non-daemon "
                    f"and hang interpreter exit unless every owner "
                    f"joins them")
                return


class SocketAudit(Rule):
    rule_id = "NNL008"
    title = "socket-audit"
    rationale = (
        "a socket with no deadline is an unbounded wait: an outbound "
        "dial into a blackholed address sits in the OS connect retry "
        "cycle (~2 minutes of SYN retransmits) wedging the dialing "
        "thread, and a blocking recv with no owner thread wedges "
        "whoever calls it — the mesh lease detector can fence a dead "
        "host in seconds only if no layer below it blocks for minutes")

    #: the serving path: every socket here sits under real traffic
    SCOPE = ("edge/", "serving/", "traffic/")
    #: creation calls we audit (module-qualified only: a bare .socket
    #: attribute or local create_connection helper is out of scope —
    #: heuristics err toward silence)
    DIAL_CALLS = ("socket.create_connection", "_socket.create_connection")
    RAW_CALLS = ("socket.socket", "_socket.socket")

    def check(self, module: Module, project: Project):
        if not any(f"/{d}" in f"/{module.path}" for d in self.SCOPE):
            return
        thread_owned = self._thread_owned_names(module.tree)
        src = module.src
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d in self.DIAL_CALLS:
                # create_connection(addr, timeout) — second positional
                # or timeout= kwarg bounds the dial
                if len(node.args) >= 2 \
                        or any(k.arg == "timeout" for k in node.keywords):
                    continue
                yield node, (
                    "outbound dial without a connect timeout: pass "
                    "timeout= (DEFAULT_CONNECT_TIMEOUT_S) — the OS "
                    "default is minutes of SYN retries and the dialing "
                    "thread wedges for all of them")
            elif d in self.RAW_CALLS:
                target = ThreadAudit._assign_target(module, node)
                if target and (f"{target}.settimeout" in src
                               or target in thread_owned):
                    continue
                yield node, (
                    "socket in the serving path with no deadline "
                    "discipline: call settimeout(), or hand it to a "
                    "dedicated reader/accept thread (NNL007-audited) "
                    "whose close path unblocks it")

    @staticmethod
    def _thread_owned_names(tree: ast.AST) -> Set[str]:
        """Names (x / self.x attrs) referenced inside a function that
        some threading.Thread/Timer in this module runs as target=.
        A socket owned by such a thread is bounded by the thread's
        lifecycle, which NNL007 separately audits."""
        targets: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and dotted(node.func).split(".")[-1] in ("Thread",
                                                             "Timer"):
                for k in node.keywords:
                    if k.arg == "target":
                        targets.add(dotted(k.value).split(".")[-1])
        owned: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in targets:
                for inner in ast.walk(node):
                    if isinstance(inner, ast.Attribute):
                        owned.add(inner.attr)
                    elif isinstance(inner, ast.Name):
                        owned.add(inner.id)
        return owned


#: a string naming one CUDA ordinal: "cuda:0", "cuda:3"
_CUDA_ORDINAL = re.compile(r"^cuda:\d+$")


def _int_const(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and type(node.value) is int


def _cuda_device_kw(call: ast.Call) -> bool:
    """`device=` names a CUDA device: "cuda", "cuda:N" or
    torch.device("cuda", ...)."""
    for k in call.keywords:
        if k.arg != "device":
            continue
        v = k.value
        if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                and v.value.split(":")[0] == "cuda":
            return True
        if isinstance(v, ast.Call) and dotted(v.func) == "torch.device" \
                and v.args and isinstance(v.args[0], ast.Constant) \
                and str(v.args[0].value).split(":")[0] == "cuda":
            return True
    return False


class PlacementAudit(Rule):
    rule_id = "NNL009"
    title = "placement-audit"
    rationale = (
        "explicit device selection (`torch.device(\"cuda\", i)`, "
        "`\"cuda:1\"`) scattered through the tree is how placement bugs "
        "are born: two call sites disagree about which card owns a "
        "model and the result is silent cross-device copies or a "
        "replica serving on the wrong card. All placement decisions "
        "route through serving/placement.py (visible_devices/device_of/"
        "accelerator_for) and parallel/ — everything else receives a "
        "device, it never picks one")

    #: the subsystem allowed to pick devices; everything else is flagged
    ALLOWED = ("serving/placement.py", "parallel/")

    def check(self, module: Module, project: Project):
        p = f"/{module.path}"
        if any(f"/{a}" in p for a in self.ALLOWED):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            pick = self._pick(node)
            if pick:
                yield node, (
                    f"explicit device pick `{pick}` outside the placement "
                    f"subsystem: take a device (or an accelerator= "
                    f"string) from the caller, or route through "
                    f"serving/placement.device_of()")

    @staticmethod
    def _pick(call: ast.Call) -> str:
        """The constant-index pick `call` makes, "" for none. Counting
        devices, "cuda" without an index and a computed index pass:
        taking the current or a caller's device is not a pick."""
        d = dotted(call.func)
        leaf = d.split(".")[-1]
        a0 = call.args[0] if call.args else None
        if d == "torch.device" and isinstance(a0, ast.Constant) \
                and a0.value == "cuda" and len(call.args) > 1 \
                and _int_const(call.args[1]):
            return f"torch.device(\"cuda\", {call.args[1].value})"
        if d in ("torch.cuda.set_device", "torch.cuda.device") \
                and _int_const(a0):
            return f"{d}({a0.value})"
        if leaf == "cuda" and isinstance(call.func, ast.Attribute) \
                and _int_const(a0):
            return f".cuda({a0.value})"
        for v in list(call.args) + [k.value for k in call.keywords]:
            if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                    and _CUDA_ORDINAL.match(v.value):
                return f"\"{v.value}\""
        return ""


class DeviceAccountingAudit(Rule):
    rule_id = "NNL010"
    title = "device-accounting"
    rationale = (
        "MFU / roofline / memory numbers are only trustworthy when "
        "'peak' and 'achieved' come from ONE accounting site. CUDA "
        "memory ledgers (`torch.cuda.memory_stats()`, "
        "`memory_allocated()`, `mem_get_info()`, ...), FLOP counts "
        "(`FlopCounterMode`) and peak-FLOPs/bandwidth constant tables "
        "live in runtime/devprof.py; everything else reports into the "
        "profiler (capture_cost / note_dispatch) and reads stats() back "
        "out")

    #: the one accounting site; everything else is flagged
    ALLOWED = ("runtime/devprof.py",)
    #: torch.cuda calls that ARE device accounting
    ACCOUNTING_CALLS = ("memory_stats", "memory_allocated",
                        "max_memory_allocated", "memory_reserved",
                        "max_memory_reserved", "mem_get_info")
    #: module/class-level constant names that smell like a peak table
    PEAK_NAMES = ("TFLOPS", "GFLOPS", "FLOPS", "GBPS", "HBM_BW")

    def check(self, module: Module, project: Project):
        p = f"/{module.path}"
        if any(f"/{a}" in p for a in self.ALLOWED):
            return
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                leaf = d.split(".")[-1]
                if d.startswith("torch.cuda.") \
                        and leaf in self.ACCOUNTING_CALLS:
                    yield node, (
                        f"device-accounting read `{d}()` outside "
                        f"runtime/devprof.py: read the ledger via "
                        f"devprof.get().stats() (or hbm_rows()) so "
                        f"'peak' and 'achieved' share one accounting "
                        f"site")
                elif leaf == "FlopCounterMode":
                    yield node, (
                        "FlopCounterMode outside runtime/devprof.py: "
                        "count a first run through DeviceProfiler."
                        "capture_cost() / devprof.flop_counter() so the "
                        "FLOPs and their peak share one accounting site")
        # peak tables: module-scope constant assignments whose name
        # declares hardware peaks (PEAK_BF16_TFLOPS, PEAK_HBM_GBPS, …)
        for node in module.tree.body:
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                name = t.id if isinstance(t, ast.Name) else ""
                if name.isupper() and "PEAK" in name and any(
                        s in name for s in self.PEAK_NAMES):
                    yield node, (
                        f"hardware peak table `{name}` outside "
                        f"runtime/devprof.py: use devprof.PEAK_TFLOPS "
                        f"/ devprof.peak_for() — a second copy is how "
                        f"MFU denominators drift")


class SeededChaosAudit(Rule):
    rule_id = "NNL011"
    title = "seeded-chaos"
    rationale = (
        "the whole value of a chaos drill is that a failure replays "
        "bit-exact from its recorded seed (scenario replay, ChaosProxy "
        "streams, shrinker repros). One `random.Random()` or "
        "`np.random.default_rng()` constructed WITHOUT a seed anywhere "
        "in the load/fault path and the repro is theater: the schedule "
        "that failed last night cannot be rebuilt. Inside the chaos "
        "paths every RNG takes an explicit seed derived from the run's "
        "root (ScenarioSpec.sub_seed / per-connection streams)")

    #: the paths where determinism is load-bearing; elsewhere an
    #: unseeded rng is someone else's design decision
    SCOPED = ("traffic/", "scenario/", "serving/worker.py")
    #: constructors that mint a fresh RNG; unseeded = zero positional
    #: args and no seed= keyword
    RNG_CALLS = ("random.Random", "np.random.default_rng",
                 "numpy.random.default_rng", "default_rng")

    def check(self, module: Module, project: Project):
        p = f"/{module.path}"
        if not any(f"/{s}" in p for s in self.SCOPED):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name not in self.RNG_CALLS:
                continue
            seeded = bool(node.args) or any(
                k.arg in ("seed", "x") for k in node.keywords)
            if not seeded:
                yield node, (
                    f"unseeded `{name}()` in a chaos/load path: pass a "
                    f"seed derived from the run's root "
                    f"(ScenarioSpec.sub_seed / the harness seed) so "
                    f"the drill replays bit-exact")


class ShardSafety(Rule):
    rule_id = "NNL012"
    title = "shard-safety"
    rationale = (
        "sharded serving's headline guarantee — shards=N is "
        "bit-identical to shards=1 — holds because every cross-device "
        "program is built by the canonical-blocking helpers in "
        "serving/sharding.py (fixed block count, fixed combine order) "
        "or the reviewed collectives in parallel/. A torch.distributed "
        "collective, process group or DeviceMesh / distribute_tensor "
        "anywhere else is a private mesh program whose reduction order "
        "depends on the shard count: exactly the numerics drift the "
        "subsystem exists to rule out. Like NNL009, everything outside "
        "the subsystem consumes sharded trees and placers, it never "
        "builds them")

    #: the subsystem allowed to build mesh programs; everything else
    #: receives placed tensors / placer callables from it
    ALLOWED = ("parallel/", "serving/sharding.py")
    #: torch.distributed's collectives and process-group calls
    DIST_CALLS = ("all_reduce", "all_gather", "all_gather_into_tensor",
                  "all_gather_object", "reduce_scatter",
                  "reduce_scatter_tensor", "all_to_all",
                  "all_to_all_single", "broadcast", "broadcast_object_list",
                  "reduce", "gather", "scatter", "send", "recv", "isend",
                  "irecv", "barrier", "init_process_group", "new_group",
                  "destroy_process_group")
    #: the device-mesh API, imported or called by name
    MESH_NAMES = ("DeviceMesh", "init_device_mesh", "distribute_tensor")

    def check(self, module: Module, project: Project):
        p = f"/{module.path}"
        if any(f"/{a}" in p for a in self.ALLOWED):
            return
        dist = self._dist_aliases(module.tree)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if not mod.startswith("torch.distributed"):
                    continue
                for alias in node.names:
                    if alias.name in self.MESH_NAMES + self.DIST_CALLS:
                        yield node, (
                            f"`from {mod} import {alias.name}` outside "
                            f"the sharding subsystem: mesh programs are "
                            f"built only in parallel/ and "
                            f"serving/sharding.py — take a placed tree "
                            f"or a placer callable from there instead")
            elif isinstance(node, ast.Call):
                d = dotted(node.func)
                head, _, leaf = d.rpartition(".")
                if leaf in self.MESH_NAMES or (
                        leaf in self.DIST_CALLS and head in dist):
                    yield node, (
                        f"`{d}(...)` outside the sharding subsystem: a "
                        f"private mesh program's reduction order depends "
                        f"on the shard count, breaking the shards=N "
                        f"bit-parity contract — route through "
                        f"serving/sharding.py (shard_llm_params / "
                        f"kv_pool_placer / make_llm_fns) or parallel/")

    @staticmethod
    def _dist_aliases(tree: ast.AST) -> Set[str]:
        """Names that stand for torch.distributed in this module."""
        out = {"torch.distributed"}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch.distributed" and a.asname:
                        out.add(a.asname)
            elif isinstance(node, ast.ImportFrom) \
                    and node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        out.add(a.asname or a.name)
        return out


class ShmSafety(Rule):
    rule_id = "NNL013"
    title = "shm-safety"
    rationale = (
        "the same-host shared-memory transport's conservation story "
        "(zero lost frames, zero orphan segments through worker "
        "kill/restart) holds because segment lifetime — create/attach/"
        "close/unlink and the resource-tracker unregister discipline — "
        "lives in exactly one module, serving/shm.py. A SharedMemory "
        "or mmap constructed anywhere else is a second lifetime "
        "story the kill drill does not audit. And on the serving hot "
        "paths, a `pickle.dumps` inside a loop re-serializes per "
        "frame — the tax the ring lane exists to remove; hoist the "
        "serialization out of the loop or route the payload through "
        "the transport")

    #: the one module allowed to own shared-memory segment lifetime
    ALLOWED = ("serving/shm.py",)
    #: where a per-frame pickle.dumps is a hot-path tax, not a choice
    HOT_PATHS = ("serving/",)

    def check(self, module: Module, project: Project):
        p = f"/{module.path}"
        if not any(f"/{a}" in p for a in self.ALLOWED):
            for node in ast.walk(module.tree):
                if isinstance(node, ast.ImportFrom):
                    mod = node.module or ""
                    if mod == "multiprocessing.shared_memory" or (
                            mod == "multiprocessing" and any(
                                a.name == "shared_memory"
                                for a in node.names)):
                        yield node, (
                            "multiprocessing.shared_memory imported "
                            "outside serving/shm.py: segment lifetime "
                            "(create/attach/close/unlink, resource-"
                            "tracker discipline) lives in ONE module — "
                            "use ShmRing from serving/shm.py")
                elif isinstance(node, ast.Call):
                    name = dotted(node.func)
                    if name.split(".")[-1] == "SharedMemory" \
                            or name == "mmap.mmap":
                        yield node, (
                            f"`{name}(...)` outside serving/shm.py: a "
                            f"shared segment constructed here has a "
                            f"lifetime the worker-kill drill does not "
                            f"audit — route through ShmRing "
                            f"(serving/shm.py)")
        if not any(f"/{s}" in p for s in self.HOT_PATHS):
            return
        seen: Set[int] = set()
        for loop in ast.walk(module.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for node in walk_no_functions(loop.body + loop.orelse):
                if id(node) in seen or not isinstance(node, ast.Call):
                    continue
                if dotted(node.func) == "pickle.dumps":
                    seen.add(id(node))
                    yield node, (
                        "per-frame `pickle.dumps` in a serving hot "
                        "loop: steady-state hops should not "
                        "re-serialize every frame — hoist the "
                        "serialization out of the loop or move the "
                        "payload onto the shm ring lane "
                        "(serving/shm.py)")


#: registry, in catalog order
ALL_RULES: List[Rule] = [
    ElementContract(), ForcedSync(), LockDiscipline(), CapturePurity(),
    SpawnSafety(), PicklableErrors(), ThreadAudit(), SocketAudit(),
    PlacementAudit(), DeviceAccountingAudit(), SeededChaosAudit(),
    ShardSafety(), ShmSafety(),
]


def iter_rules(only: Optional[Iterable[str]] = None) -> List[Rule]:
    if not only:
        return list(ALL_RULES)
    want = {r.strip().upper() for r in only}
    unknown = want - {r.rule_id for r in ALL_RULES}
    if unknown:
        raise ValueError(
            f"unknown rule id(s) {sorted(unknown)}; available: "
            f"{[r.rule_id for r in ALL_RULES]}")
    return [r for r in ALL_RULES if r.rule_id in want]
