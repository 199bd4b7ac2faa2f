"""Contract code as attachment data: the restricted execution path (copy of
corda_tpu/ledger/attachment_code.py).

Capability parity with the reference's attachments classloader
(node-api/.../AttachmentsClassLoader.kt:24 — contract classes load from
attachment JARs carried BY the transaction, so a node can verify a
transaction from a counterparty whose CorDapp it never installed;
constraint check at LedgerTransaction.kt:92-106). Here the attachment
carries Python contract SOURCE, executed under an explicit restriction
gate rather than a JVM classloader:

- the source must parse to an AST from a WHITELISTED node set — no
  imports, no attribute or name starting with ``_`` (blocks every dunder
  escape: ``__class__``/``__subclasses__``/``__globals__``), no
  ``global``/``nonlocal``, no lambda-smuggled exec;
- execution gets a frozen builtins table of pure functions (len, sum,
  sorted, isinstance, the exception types contracts raise, ...) — no
  ``open``, ``eval``, ``getattr``, ``type`` or import machinery;
- the module must export ``CONTRACTS = {"name": cls}``; classes are
  cached by attachment hash (content-addressed, so the cache is sound).

Threat model note: this bounds AUTHORITY (no I/O, no
process or interpreter state access), like the reference's classloader —
neither meters CPU/memory, so a hostile attachment can still spin; the
out-of-process verifier tier is the containment for that, exactly as the
reference isolates verification in separate JVMs.

Resolution precedence: locally REGISTERED contracts always win (the
node's own audited code); attachment code only fills names the registry
does not know. Constraints still apply unchanged — a state pinned by
``HashAttachmentConstraint`` accepts only the exact code hash it names.
"""

from __future__ import annotations

import ast
import builtins as _builtins
import functools

from ..crypto import SecureHash, sha256

from .states import TransactionVerificationException

MAX_SOURCE_BYTES = 256 * 1024
MAX_AST_NODES = 20_000

_ALLOWED_NODES = (
    ast.Module, ast.FunctionDef, ast.ClassDef, ast.Return, ast.Assign,
    ast.AugAssign, ast.AnnAssign, ast.For, ast.While, ast.If, ast.Expr,
    ast.Pass, ast.Break, ast.Continue, ast.BoolOp, ast.BinOp, ast.UnaryOp,
    ast.IfExp, ast.Dict, ast.Set, ast.ListComp, ast.SetComp, ast.DictComp,
    ast.GeneratorExp, ast.Compare, ast.Call, ast.Constant, ast.Attribute,
    ast.Subscript, ast.Starred, ast.Name, ast.List, ast.Tuple, ast.Slice,
    ast.Load, ast.Store, ast.Del, ast.And, ast.Or, ast.Add, ast.Sub,
    ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow, ast.LShift,
    ast.RShift, ast.BitOr, ast.BitXor, ast.BitAnd, ast.Invert, ast.Not,
    ast.UAdd, ast.USub, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt,
    ast.GtE, ast.Is, ast.IsNot, ast.In, ast.NotIn, ast.arguments, ast.arg,
    ast.keyword, ast.comprehension, ast.Raise, ast.Try, ast.ExceptHandler,
    ast.Assert, ast.JoinedStr, ast.FormattedValue, ast.Lambda,
)

_SAFE_BUILTINS = {
    # class statements compile to a __build_class__ call; exposing it only
    # creates plain classes (metaclass smuggling is blocked by the AST
    # gate: keywords and dunder names are rejected)
    "__build_class__": _builtins.__build_class__,
    "__name__": "attachment",
}
_SAFE_BUILTINS |= {
    name: getattr(_builtins, name)
    for name in (
        "abs", "all", "any", "bool", "bytes", "dict", "divmod", "enumerate",
        "filter", "float", "frozenset", "hash", "int", "isinstance", "len",
        "list", "map", "max", "min", "range", "repr", "reversed", "round",
        "set", "sorted", "str", "sum", "tuple", "zip",
        "ValueError", "TypeError", "KeyError", "IndexError",
        "ArithmeticError", "ZeroDivisionError", "AssertionError",
        "Exception", "StopIteration", "True", "False", "None",
    )
    if hasattr(_builtins, name)
}


class ForbiddenContractCode(TransactionVerificationException):
    def __init__(self, reason: str):
        super().__init__(None, f"attachment contract code rejected: {reason}")


# names rejected STATICALLY even though execution would fail anyway (they
# are absent from the frozen builtins) — defense in depth, and a clear
# error at validation time instead of a NameError mid-verify
_BANNED_NAMES = frozenset({
    "open", "eval", "exec", "compile", "input", "breakpoint", "exit",
    "quit", "getattr", "setattr", "delattr", "globals", "locals", "vars",
    "type", "super", "object", "memoryview", "dir", "id", "help",
    "classmethod", "staticmethod", "property", "print",
})


def validate_contract_source(source: bytes) -> ast.Module:
    """Parse + gate the AST; raises ForbiddenContractCode on any escape
    hatch. Deliberately rejects rather than sanitises — unknown syntax is
    hostile syntax."""
    if len(source) > MAX_SOURCE_BYTES:
        raise ForbiddenContractCode("source too large")
    try:
        tree = ast.parse(source.decode("utf-8"))
    except (SyntaxError, UnicodeDecodeError) as e:
        raise ForbiddenContractCode(f"unparseable: {e}") from e
    count = 0
    for node in ast.walk(tree):
        count += 1
        if count > MAX_AST_NODES:
            raise ForbiddenContractCode("AST too large")
        if not isinstance(node, _ALLOWED_NODES):
            raise ForbiddenContractCode(
                f"disallowed syntax: {type(node).__name__}"
            )
        if isinstance(node, (ast.Name, ast.Attribute, ast.FunctionDef,
                             ast.ClassDef, ast.arg)):
            ident = (
                node.id if isinstance(node, ast.Name)
                else node.attr if isinstance(node, ast.Attribute)
                else node.arg if isinstance(node, ast.arg)
                else node.name
            )
            if ident.startswith("_"):
                raise ForbiddenContractCode(
                    f"underscore identifier {ident!r} (dunder escape gate)"
                )
            if ident in _BANNED_NAMES:
                raise ForbiddenContractCode(f"banned name {ident!r}")
        if isinstance(node, ast.keyword) and node.arg and node.arg.startswith("_"):
            raise ForbiddenContractCode("underscore keyword argument")
    return tree


@functools.lru_cache(maxsize=256)
def load_attachment_contracts(attachment_bytes: bytes) -> dict:
    """Execute validated contract source → {contract_name: contract_class}.
    Cached by content (the attachment bytes ARE the identity)."""
    tree = validate_contract_source(attachment_bytes)
    code = compile(tree, "<attachment>", "exec")
    namespace: dict = {"__builtins__": dict(_SAFE_BUILTINS)}
    try:
        exec(code, namespace)  # noqa: S102 — gated above
    except Exception as e:
        raise ForbiddenContractCode(f"module body failed: {e}") from e
    contracts = namespace.get("CONTRACTS")
    if not isinstance(contracts, dict) or not contracts:
        raise ForbiddenContractCode(
            "module must export CONTRACTS = {name: class}"
        )
    out = {}
    for name, cls in contracts.items():
        if not isinstance(name, str) or not callable(cls) or not hasattr(
            cls, "verify"
        ):
            raise ForbiddenContractCode(
                f"CONTRACTS entry {name!r} is not a verify-bearing class"
            )
        out[name] = cls
    return out


# ---------------------------------------------------------------- resolver

_attachment_fetcher = None  # fn(SecureHash) -> bytes | None


def set_attachment_fetcher(fn) -> None:
    """Node boot wires this to its attachment storage ``get``; the verify
    path then resolves unknown contract names from transaction-carried
    attachments."""
    global _attachment_fetcher
    _attachment_fetcher = fn


def resolve_from_attachments(
    name: str, attachment_hashes: tuple
) -> tuple[type, SecureHash] | None:
    """Find ``name`` among the contracts defined by the transaction's OWN
    attachments → (class, code_hash). Returns None when unknown. The code
    hash returned is the ACTUAL attachment content hash, which the state's
    constraint is checked against — a HashAttachmentConstraint therefore
    pins the exact code that will run."""
    if _attachment_fetcher is None:
        return None
    for att_hash in attachment_hashes:
        data = _attachment_fetcher(att_hash)
        if data is None:
            continue
        if sha256(data) != att_hash:
            continue  # storage corruption or forged id: never execute
        try:
            contracts = load_attachment_contracts(data)
        except ForbiddenContractCode:
            continue  # other attachments may still carry the contract
        cls = contracts.get(name)
        if cls is not None:
            return cls, att_hash
    return None
