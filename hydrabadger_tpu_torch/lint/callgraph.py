"""Package-wide call graph: who calls whom, resolved statically.

The per-file rules in this package see one module at a time; the
dataflow passes (taint, secrets) need to follow a value from
``net/wire.py`` into ``crypto/dkg.py`` and down to an ``ops/msm_torch.py``
kernel wrapper.  This module builds the index that makes
that possible: every function/method definition under the package root,
plus every call site resolved to its likely targets.

Resolution is LINT-GRADE, not a type checker: it must be right on the
package's own idioms and silent (unresolved) elsewhere.  A call is
resolved through, in order:

  1. **local + imported names** — ``foo(...)`` to a module-level def,
     ``mod.foo(...)`` / ``from mod import foo`` through the module's
     import table (package-relative and absolute imports);
  2. **self dispatch** — ``self.meth(...)`` through the enclosing
     class, walking package-local base classes (``GpuEngine(CpuEngine)``
     finds inherited methods);
  3. **typed receivers** — ``obj.meth(...)`` when ``obj``'s class is
     known from a parameter annotation, a dataclass field annotation, a
     ``self.x = ClassName(...)`` assignment in ``__init__``, or a local
     ``obj = ClassName(...)`` assignment;
  4. **factory dispatch** — a receiver produced by a registered factory
     resolves against every class the factory can return
     (``get_engine`` -> ``CpuEngine`` | ``GpuEngine``: the CryptoEngine
     registry is how the whole crypto plane is reached, so this edge is
     load-bearing for the taint passes);
  5. **unique-method fallback** — a bare ``obj.meth(...)`` whose method
     name is defined by at most two package classes resolves to all of
     them; anything more ambiguous stays unresolved (an unresolved call
     is treated conservatively by the passes).

Constructor calls resolve to the class's ``__init__`` (or to the class
itself for dataclasses without one), tagged ``kind="ctor"`` so dataflow
can treat the result as an instance of that class.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import SourceFile, dotted_name

# Factories whose return type is an open registry: receiver methods
# resolve against every listed class.  (crypto.engine.get_engine is THE
# dispatch point of the crypto plane.)
FACTORY_RETURNS: Dict[str, Tuple[str, ...]] = {
    "get_engine": ("CpuEngine", "GpuEngine"),
}

# method names stdlib containers/paths also define: excluded from the
# unique-method fallback (a receiver must be TYPED to resolve these)
_STDLIB_COLLIDING = frozenset(
    {
        "get",
        "put",
        "add",
        "pop",
        "popitem",
        "update",
        "clear",
        "copy",
        "items",
        "keys",
        "values",
        "setdefault",
        "append",
        "appendleft",
        "extend",
        "insert",
        "index",
        "count",
        "sort",
        "remove",
        "discard",
        "join",
        "split",
        "strip",
        "upper",
        "lower",
        "read",
        "write",
        "close",
        "resolve",
        "exists",
        "encode",
        "decode",
        "get_nowait",
        "put_nowait",
        "qsize",
        "empty",
        "move_to_end",
        "popleft",
    }
)

# stdlib containers: receivers of this type never resolve to package
# methods (their method names collide — set.add vs Peers.add)
_BUILTIN_CONTAINERS = frozenset(
    {
        "set",
        "dict",
        "list",
        "tuple",
        "frozenset",
        "bytearray",
        "deque",
        "defaultdict",
        "Counter",
        "OrderedDict",
        "Queue",
        "LifoQueue",
        "PriorityQueue",
    }
)


@dataclass
class FuncInfo:
    """One function or method definition."""

    qualname: str  # "net/node.py::Hydrabadger._on_peer_msg"
    relpath: str
    cls: Optional[str]  # enclosing class name, if a method
    name: str  # bare name
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    params: List[str] = field(default_factory=list)  # incl. self

    @property
    def lineno(self) -> int:
        return self.node.lineno


@dataclass
class ClassInfo:
    qualname: str  # "crypto/engine.py::GpuEngine"
    relpath: str
    name: str
    node: ast.ClassDef
    bases: List[str] = field(default_factory=list)  # bare base names
    methods: Dict[str, FuncInfo] = field(default_factory=dict)
    # attr name -> class name, from __init__ assignments and dataclass
    # field annotations (the receiver-type table for rule 3)
    attr_types: Dict[str, str] = field(default_factory=dict)


@dataclass
class CallSite:
    caller: str  # qualname of the calling function ("" = module level)
    relpath: str
    node: ast.Call
    dotted: Optional[str]
    targets: List[str] = field(default_factory=list)  # resolved qualnames
    kind: str = "call"  # "call" | "ctor"
    # resolution confidence: "typed" for rules 1-4, "fallback" for the
    # rule-5 unique-method guess.  Reachability-style consumers (the
    # blocking-in-async pass) skip fallback edges — a guessed edge into
    # a blocking helper would smear findings across unrelated planes.
    via: str = "typed"


# typing-module container heads: a slot annotated with one of these is
# a stdlib container, not a package class
_TYPING_CONTAINERS = frozenset(
    {
        "Dict",
        "List",
        "Set",
        "FrozenSet",
        "Tuple",
        "Deque",
        "DefaultDict",
        "OrderedDict",
        "Counter",
        "Mapping",
        "MutableMapping",
        "Sequence",
        "Iterable",
    }
)


def _annotation_class(ann: Optional[ast.AST]) -> Optional[str]:
    """'Peer' from ``x: Peer`` / ``x: Optional[Peer]`` / ``x: "Peer"``;
    '#builtin' for container annotations (``Dict[int, bytes]``)."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        name = ann.value.strip().strip('"')
        head = name.split("[")[0].split(".")[-1]
        if head in _TYPING_CONTAINERS or head in _BUILTIN_CONTAINERS:
            return "#builtin"
        return head or None
    if isinstance(ann, ast.Name):
        if ann.id in _TYPING_CONTAINERS or ann.id in _BUILTIN_CONTAINERS:
            return "#builtin"
        return ann.id
    if isinstance(ann, ast.Subscript):  # Optional[Peer], Dict[k, v]
        head = None
        if isinstance(ann.value, ast.Name):
            head = ann.value.id
        elif isinstance(ann.value, ast.Attribute):
            head = ann.value.attr
        if head in _TYPING_CONTAINERS or head in _BUILTIN_CONTAINERS:
            return "#builtin"
        inner = ann.slice  # Optional[Peer] / Union[...]
        if isinstance(inner, ast.Tuple) and inner.elts:
            inner = inner.elts[0]
        return _annotation_class(inner)
    if isinstance(ann, ast.Attribute):
        return ann.attr
    return None


class CallGraph:
    def __init__(self, root: Path):
        self.root = root
        self.functions: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}  # by qualname
        self.classes_by_name: Dict[str, List[ClassInfo]] = {}
        self.methods_by_name: Dict[str, List[FuncInfo]] = {}
        self.funcs_by_module: Dict[str, Dict[str, FuncInfo]] = {}
        self.imports: Dict[str, Dict[str, str]] = {}  # relpath -> alias -> target
        self.calls_by_caller: Dict[str, List[CallSite]] = {}
        self.callers_of: Dict[str, List[CallSite]] = {}
        self.sources: Dict[str, SourceFile] = {}
        self._func_by_node: Dict[int, FuncInfo] = {}

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, sources: Sequence[SourceFile], root: Path) -> "CallGraph":
        g = cls(root)
        for sf in sources:
            g.sources[sf.relpath] = sf
        for sf in sources:
            g._index_module(sf)
        for sf in sources:
            g._index_imports(sf)
        g._link_bases()
        for sf in sources:
            g._resolve_calls(sf)
        return g

    def _index_module(self, sf: SourceFile) -> None:
        mod_funcs: Dict[str, FuncInfo] = {}
        self.funcs_by_module[sf.relpath] = mod_funcs

        def add_func(node, cls_info: Optional[ClassInfo], prefix: str) -> None:
            bare = node.name
            if cls_info is not None:
                qual = f"{sf.relpath}::{cls_info.name}.{bare}"
            elif prefix:
                qual = f"{sf.relpath}::{prefix}.{bare}"
            else:
                qual = f"{sf.relpath}::{bare}"
            fi = FuncInfo(
                qualname=qual,
                relpath=sf.relpath,
                cls=cls_info.name if cls_info else None,
                name=bare,
                node=node,
                params=[a.arg for a in node.args.args],
            )
            self.functions[qual] = fi
            if cls_info is not None:
                cls_info.methods[bare] = fi
                self.methods_by_name.setdefault(bare, []).append(fi)
            else:
                # module-level defs own the bare-name lookup; a nested
                # helper only claims a name no module-level def holds
                # (it must never shadow a later top-level function)
                is_nested = bool(prefix)
                prev = mod_funcs.get(bare)
                prev_nested = prev is not None and "." in prev.qualname.split(
                    "::", 1
                )[1]
                if prev is None or (prev_nested and not is_nested):
                    mod_funcs[bare] = fi
            self._func_by_node[id(node)] = fi
            for sub in ast.iter_child_nodes(node):
                walk(sub, cls_info=None,
                     prefix=(f"{prefix}.{bare}" if prefix else bare),
                     in_func=True)

        def walk(node, cls_info=None, prefix="", in_func=False):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add_func(node, cls_info, prefix)
                return
            if isinstance(node, ast.ClassDef) and not in_func:
                ci = ClassInfo(
                    qualname=f"{sf.relpath}::{node.name}",
                    relpath=sf.relpath,
                    name=node.name,
                    node=node,
                    bases=[
                        b for b in (dotted_name(x) for x in node.bases) if b
                    ],
                )
                self.classes[ci.qualname] = ci
                self.classes_by_name.setdefault(node.name, []).append(ci)
                for ann in node.body:  # dataclass field annotations
                    if isinstance(ann, ast.AnnAssign) and isinstance(
                        ann.target, ast.Name
                    ):
                        t = _annotation_class(ann.annotation)
                        if t:
                            ci.attr_types[ann.target.id] = t
                for sub in ast.iter_child_nodes(node):
                    walk(sub, cls_info=ci, prefix="", in_func=False)
                self._harvest_init_types(ci)
                return
            for sub in ast.iter_child_nodes(node):
                walk(sub, cls_info=cls_info, prefix=prefix, in_func=in_func)

        for top in sf.tree.body:
            walk(top)

    def _harvest_init_types(self, ci: ClassInfo) -> None:
        init = ci.methods.get("__init__")
        if init is None:
            return
        param_types = {
            a.arg: _annotation_class(a.annotation)
            for a in init.node.args.args
        }
        for node in ast.walk(init.node):
            if isinstance(node, ast.AnnAssign):
                # self.dhb: Optional[DynamicHoneyBadger] = None
                t = node.target
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    ann = _annotation_class(node.annotation)
                    if ann and ann in _BUILTIN_CONTAINERS:
                        ci.attr_types.setdefault(t.attr, "#builtin")
                    elif ann:
                        ci.attr_types.setdefault(t.attr, ann)
                continue
            if not isinstance(node, ast.Assign):
                continue
            cls_name = None
            if isinstance(node.value, ast.Call):
                ctor = dotted_name(node.value.func) or ""
                parts = ctor.split(".")
                # bare ClassName(...), classmethod ctors
                # (SecretKey.random(...)), and module-qualified forms
                # (th.SecretKey.from_bytes(...)) all type the slot
                cls_name = next(
                    (p for p in parts if p and p[0].isupper()), parts[-1]
                )
            elif isinstance(node.value, ast.Name):
                # self.x = <annotated __init__ parameter>
                cls_name = param_types.get(node.value.id)
            if not cls_name:
                continue
            factory = (
                FACTORY_RETURNS.get(cls_name)
                if isinstance(node.value, ast.Call)
                else None
            )
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    if factory:
                        ci.attr_types.setdefault(t.attr, factory[0])
                        ci.attr_types[t.attr + "#factory"] = cls_name
                    elif cls_name in _BUILTIN_CONTAINERS:
                        # stdlib container: its methods must never fall
                        # through to the unique-method fallback (set.add
                        # is not Peers.add)
                        ci.attr_types.setdefault(t.attr, "#builtin")
                    elif cls_name and cls_name[0].isupper():
                        ci.attr_types.setdefault(t.attr, cls_name)

    def _index_imports(self, sf: SourceFile) -> None:
        table: Dict[str, str] = {}
        self.imports[sf.relpath] = table
        pkg_parts = sf.relpath.split("/")[:-1]  # dirs under package root

        def module_to_relpath(dotted_mod: str) -> Optional[str]:
            parts = [p for p in dotted_mod.split(".") if p]
            if not parts:
                return None
            for cand in (
                "/".join(parts) + ".py",
                "/".join(parts) + "/__init__.py",
            ):
                if cand in self.sources or (self.root / cand).exists():
                    return cand
            return None

        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                    mod = ".".join(
                        base + [p for p in (node.module or "").split(".") if p]
                    )
                else:
                    mod = node.module or ""
                    # strip the package's own absolute prefix if present
                    mod = mod.split("hydrabadger_tpu_torch.")[-1]
                rel = module_to_relpath(mod)
                for alias in node.names:
                    bound = alias.asname or alias.name
                    # submodule first: `from ..utils import codec` binds
                    # the MODULE utils/codec.py, not a name in __init__
                    sub = module_to_relpath(
                        (mod + "." + alias.name).lstrip(".")
                    )
                    if sub is not None:
                        table[bound] = sub  # imported a module itself
                    elif rel is not None:
                        table[bound] = f"{rel}::{alias.name}"
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    mod = alias.name.split("hydrabadger_tpu_torch.")[-1]
                    rel = module_to_relpath(mod)
                    if rel is not None:
                        table[alias.asname or mod.split(".")[0]] = rel

    def _link_bases(self) -> None:
        for ci in self.classes.values():
            resolved = []
            for b in ci.bases:
                bare = b.split(".")[-1]
                for cand in self.classes_by_name.get(bare, []):
                    resolved.append(cand)
            ci._base_infos = resolved  # type: ignore[attr-defined]

    # -- class helpers ------------------------------------------------------

    def mro_method(self, ci: ClassInfo, meth: str) -> Optional[FuncInfo]:
        seen: Set[str] = set()
        stack = [ci]
        while stack:
            cur = stack.pop(0)
            if cur.qualname in seen:
                continue
            seen.add(cur.qualname)
            if meth in cur.methods:
                return cur.methods[meth]
            stack.extend(getattr(cur, "_base_infos", []))
        return None

    def class_named(self, name: str) -> List[ClassInfo]:
        return self.classes_by_name.get(name, [])

    # -- call resolution ----------------------------------------------------

    def _resolve_calls(self, sf: SourceFile) -> None:
        table = self.imports.get(sf.relpath, {})

        def lookup_class_of(var: str, fn: FuncInfo) -> Optional[str]:
            """Receiver type of ``var`` inside ``fn`` (rules 3-4)."""
            node = fn.node
            for a in node.args.args:
                if a.arg == var:
                    t = _annotation_class(a.annotation)
                    if t == "#builtin":
                        return t
                    if t and self.class_named(t):
                        return t
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and isinstance(
                    sub.value, ast.Call
                ):
                    ctor = (dotted_name(sub.value.func) or "").split(".")[-1]
                    for t in sub.targets:
                        if isinstance(t, ast.Name) and t.id == var:
                            if self.class_named(ctor):
                                return ctor
                            if ctor in FACTORY_RETURNS:
                                return f"#factory:{ctor}"
                            if ctor in _BUILTIN_CONTAINERS:
                                return "#builtin"
            return None

        def resolve(call: ast.Call, fn: Optional[FuncInfo]) -> CallSite:
            dn = dotted_name(call.func)
            site = CallSite(
                caller=fn.qualname if fn else "",
                relpath=sf.relpath,
                node=call,
                dotted=dn,
            )
            if dn is None:
                return site
            parts = dn.split(".")
            bare = parts[-1]

            def add_func_target(qual: str, kind="call") -> None:
                if qual in self.functions:
                    site.targets.append(qual)
                    site.kind = kind

            def add_class_target(name: str) -> None:
                for ci in self.class_named(name):
                    init = self.mro_method(ci, "__init__")
                    if init is not None:
                        site.targets.append(init.qualname)
                    else:
                        site.targets.append(ci.qualname)
                    site.kind = "ctor"

            def add_method_targets(cls_name: str, meth: str) -> None:
                if cls_name.startswith("#factory:"):
                    for ret in FACTORY_RETURNS[cls_name.split(":", 1)[1]]:
                        add_method_targets(ret, meth)
                    return
                for ci in self.class_named(cls_name):
                    mi = self.mro_method(ci, meth)
                    if mi is not None:
                        site.targets.append(mi.qualname)

            def alias_targets(var: str, scope: FuncInfo) -> List[str]:
                """``f = a if cond else b; f(x)`` — resolve a
                local alias bound to module-level function references."""
                out: List[str] = []
                mod_funcs = self.funcs_by_module.get(sf.relpath, {})
                for sub in ast.walk(scope.node):
                    if not isinstance(sub, ast.Assign):
                        continue
                    if not any(
                        isinstance(t, ast.Name) and t.id == var
                        for t in sub.targets
                    ):
                        continue
                    refs = [sub.value]
                    if isinstance(sub.value, ast.IfExp):
                        refs = [sub.value.body, sub.value.orelse]
                    for ref in refs:
                        if isinstance(ref, ast.Name) and ref.id in mod_funcs:
                            out.append(mod_funcs[ref.id].qualname)
                return out

            if len(parts) == 1:
                # rule 1: local def or imported name
                local = self.funcs_by_module.get(sf.relpath, {}).get(bare)
                aliases = (
                    alias_targets(bare, fn)
                    if local is None and fn is not None
                    else []
                )
                if local is not None:
                    site.targets.append(local.qualname)
                elif aliases:
                    site.targets.extend(aliases)
                elif bare in table:
                    tgt = table[bare]
                    if "::" in tgt:
                        rel, name = tgt.split("::", 1)
                        fqual = f"{rel}::{name}"
                        if fqual in self.functions:
                            site.targets.append(fqual)
                        else:
                            add_class_target(name)
                elif self.class_named(bare):
                    add_class_target(bare)
                return site

            base, meth = parts[0], parts[-1]
            if base == "self" and fn is not None and fn.cls is not None:
                if len(parts) == 2:
                    # rule 2: self.meth()
                    add_method_targets(fn.cls, meth)
                else:
                    # self.attr.meth(): attr type from the class table
                    for ci in self.class_named(fn.cls):
                        factory = ci.attr_types.get(parts[1] + "#factory")
                        attr_t = ci.attr_types.get(parts[1])
                        if factory:
                            add_method_targets(f"#factory:{factory}", meth)
                        elif attr_t == "#builtin":
                            return site  # stdlib container method
                        elif attr_t is not None:
                            add_method_targets(attr_t, meth)
                if site.targets:
                    return site
            if base in table and len(parts) == 2:
                tgt = table[base]
                if "::" not in tgt:  # imported module: mod.fn()
                    fqual = f"{tgt}::{meth}"
                    add_func_target(fqual)
                    if not site.targets:
                        add_class_target(meth)
                    # the receiver IS that module: an unknown symbol
                    # (e.g. an alias assignment like codec.encode) must
                    # stay unresolved, never guess via the fallback
                    return site
                else:  # imported class: Class.staticish()
                    rel, name = tgt.split("::", 1)
                    add_method_targets(name, meth)
                    if site.targets:
                        return site
            if self.class_named(base):  # ClassName.method(...)
                add_method_targets(base, meth)
                if site.targets:
                    return site
            if fn is not None and len(parts) == 2:
                cls_name = lookup_class_of(base, fn)
                if cls_name == "#builtin":
                    return site  # stdlib container method
                if cls_name:
                    add_method_targets(cls_name, meth)
                    if site.targets:
                        return site
            # rule 5: unique-method fallback — but never for method
            # names stdlib containers also define (set.add is not
            # Peers.add, dict.get is not DigestLRU.get)
            if meth not in _STDLIB_COLLIDING:
                cands = self.methods_by_name.get(meth, [])
                if 0 < len(cands) <= 2:
                    site.targets.extend(mi.qualname for mi in cands)
                    site.via = "fallback"
            return site

        # attribute calls + plain calls, attributed to their enclosing fn
        def walk(node, fn: Optional[FuncInfo]):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = self._func_for_node(sf.relpath, node)
                fn = inner or fn
            for sub in ast.iter_child_nodes(node):
                walk(sub, fn)
            if isinstance(node, ast.Call):
                site = resolve(node, fn)
                self.calls_by_caller.setdefault(site.caller, []).append(site)
                for t in site.targets:
                    self.callers_of.setdefault(t, []).append(site)

        walk(sf.tree, None)

    def _func_for_node(self, relpath: str, node) -> Optional[FuncInfo]:
        return self._func_by_node.get(id(node))

    # -- queries ------------------------------------------------------------

    def reachable_from(self, roots: Sequence[str]) -> Set[str]:
        seen: Set[str] = set()
        stack = [r for r in roots if r in self.functions]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            for site in self.calls_by_caller.get(cur, []):
                stack.extend(t for t in site.targets if t not in seen)
        return seen


# -- memoised package graph --------------------------------------------------

_GRAPH_CACHE: Dict[str, CallGraph] = {}


def build(root: Path, sources: Optional[Sequence[SourceFile]] = None) -> CallGraph:
    """Build (or fetch the memoised) call graph for ``root``.

    The real package is parsed once per process; explicit ``sources``
    (test fixtures) bypass the cache.
    """
    if sources is not None:
        return CallGraph.build(list(sources), root)
    key = str(root.resolve())
    if key not in _GRAPH_CACHE:
        from . import iter_sources

        _GRAPH_CACHE[key] = CallGraph.build(list(iter_sources(root)), root)
    return _GRAPH_CACHE[key]
