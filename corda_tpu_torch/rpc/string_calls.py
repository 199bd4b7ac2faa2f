"""Human-typed strings → ready-to-invoke method calls (the port's copy of
corda_tpu/rpc/string_calls.py, import root changed).

Capability parity with the reference's StringToMethodCallParser
(client/jackson/.../StringToMethodCallParser.kt: "the first word is the
name of the method; the rest is parsed as if it were a Yaml object" whose
keys map to the method's parameters) — the engine behind the shell's
``run``/``flow start`` commands and text-based RPC dispatch.

Syntax::

    someCall note: this is a helpful feature, option: true
    start_flow_dynamic flow: corda_tpu_torch.finance.flows.CashPaymentFlow,
        quantity: 100, currency: GBP, recipient: "O=Bank B, L=Rome, C=GB"

Barewords collapse into strings (quotes only needed around commas/colons);
values convert to each parameter's ANNOTATED type through a ``JsonMapper``
— so parties resolve by X.500 name, hashes parse from hex, amounts from
``"100 GBP"``, exactly as in JSON bodies.
"""

from __future__ import annotations

import dataclasses
import inspect
import typing

from .json_support import JsonMapper, JsonSerializationError


class CallParseError(Exception):
    pass


def _split_top_level(s: str, sep: str) -> list[str]:
    """Split on ``sep`` outside quotes and brackets."""
    out, depth, quote, cur = [], 0, None, []
    for ch in s:
        if quote:
            if ch == quote:
                quote = None
            cur.append(ch)
            continue
        if ch in "\"'":
            quote = ch
            cur.append(ch)
        elif ch in "[{(":
            depth += 1
            cur.append(ch)
        elif ch in ")}]":
            depth -= 1
            cur.append(ch)
        elif ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def _parse_scalar(token: str):
    token = token.strip()
    if len(token) >= 2 and token[0] in "\"'" and token[-1] == token[0]:
        return token[1:-1]
    if token == "true":
        return True
    if token == "false":
        return False
    if token == "null":
        return None
    if token.startswith("[") and token.endswith("]"):
        inner = token[1:-1].strip()
        if not inner:
            return []
        return [_parse_scalar(t) for t in _split_top_level(inner, ",")]
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token)
    except ValueError:
        pass
    return token  # bareword → string


def parse_argument_string(s: str) -> dict:
    """``"a: 1, b: hello world, c: [1, 2]"`` → raw key/value dict."""
    s = s.strip()
    if not s:
        return {}
    if s.startswith("{") and s.endswith("}"):
        s = s[1:-1]
    out = {}
    for part in _split_top_level(s, ","):
        part = part.strip()
        if not part:
            continue
        key, colon, raw = part.partition(":")
        if not colon:
            raise CallParseError(f"expected 'key: value', got {part!r}")
        out[key.strip()] = _parse_scalar(raw)
    return out


@dataclasses.dataclass
class ParsedMethodCall:
    """A ready-to-invoke call (reference: ParsedMethodCall — a Callable
    over the target)."""

    target: object
    method_name: str
    kwargs: dict

    def invoke(self):
        return getattr(self.target, self.method_name)(**self.kwargs)

    __call__ = invoke


class StringToMethodCallParser:
    """Parses call strings against ``target``'s public methods, converting
    each argument to the parameter's annotated type via ``mapper``."""

    def __init__(self, target, mapper: JsonMapper | None = None):
        self.target = target
        self.mapper = mapper or JsonMapper()

    def available_commands(self) -> dict:
        """method name → signature string help (reference:
        methodsFromType / the shell's command listing)."""
        out = {}
        for name, fn in inspect.getmembers(self.target, callable):
            if name.startswith("_"):
                continue
            try:
                out[name] = str(inspect.signature(fn))
            except (TypeError, ValueError):
                out[name] = "(...)"
        return out

    def parse(self, line: str) -> ParsedMethodCall:
        line = line.strip()
        if not line:
            raise CallParseError("empty command")
        name, _, rest = line.partition(" ")
        fn = getattr(self.target, name, None)
        if fn is None or not callable(fn) or name.startswith("_"):
            raise CallParseError(f"no such method: {name!r}")
        raw = parse_argument_string(rest)
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            return ParsedMethodCall(self.target, name, raw)
        try:
            hints = typing.get_type_hints(fn)
        except Exception:
            hints = {}
        kwargs = {}
        for pname, param in sig.parameters.items():
            if pname in ("self", "args", "kwargs"):
                continue
            if pname not in raw:
                if param.default is inspect.Parameter.empty:
                    raise CallParseError(
                        f"{name}: missing argument {pname!r} "
                        f"(signature {sig})"
                    )
                continue
            value = raw.pop(pname)
            want = hints.get(pname)
            if want is not None:
                try:
                    value = self.mapper.parse(value, want)
                except JsonSerializationError as e:
                    raise CallParseError(
                        f"{name}: argument {pname!r}: {e}"
                    ) from e
            kwargs[pname] = value
        if raw:
            raise CallParseError(
                f"{name}: unknown argument(s) {sorted(raw)} "
                f"(signature {sig})"
            )
        return ParsedMethodCall(self.target, name, kwargs)

    def invoke(self, line: str):
        return self.parse(line).invoke()
