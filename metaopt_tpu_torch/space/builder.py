"""The ``name~prior(...)`` DSL: parse priors out of a user command line or a
config-file template, and build (Space, CommandTemplate).

Port of ``metaopt_tpu/space/builder.py``:

    python -m metaopt_tpu_torch hunt -n exp ./train.py \
        --lr~'loguniform(1e-5, 1e-1)' --layers~'uniform(1, 8, discrete=True)'

Prior expressions are evaluated with a restricted AST walker (literals
only), never ``eval``; config-template keys are named by their dotted path.
"""

from __future__ import annotations

import ast
import copy
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

from metaopt_tpu_torch.io.converters import infer_converter
from metaopt_tpu_torch.space.dimensions import (
    Categorical,
    Dimension,
    Fidelity,
    Integer,
    Real,
)
from metaopt_tpu_torch.space.space import Space

#: token shapes accepted: ``--name~prior(...)``, ``-n~prior(...)``,
#: ``name~prior(...)``
_TOKEN_RE = re.compile(
    r"""^(?P<dashes>-{0,2})          # optional leading dashes
        (?P<name>[A-Za-z0-9_][A-Za-z0-9_.\-/]*)   # param name
        ~                            # the DSL marker
        (?P<expr>[A-Za-z_][A-Za-z0-9_]*\(.*\))$   # prior call
    """,
    re.VERBOSE | re.DOTALL,
)

#: ``name~prior(...)`` occurrences inside a TEXT config template (the
#: generic-converter fallback): one nesting level of parens so kwargs like
#: ``shape=(2, 2)`` parse
_TEXT_RE = re.compile(
    r"(?P<name>[A-Za-z_][A-Za-z0-9_.\-]*)"
    r"~(?P<expr>[A-Za-z_][A-Za-z0-9_]*\((?:[^()]|\([^()]*\))*\))"
)

#: prior-name → dimension class routing (``discrete=True`` reroutes to Integer)
_REAL_PRIORS = {"uniform", "loguniform", "normal"}
_INT_PRIORS = {"randint"}
_KNOWN_PRIORS = _REAL_PRIORS | _INT_PRIORS | {"choices", "fidelity"}


class PriorSyntaxError(ValueError):
    pass


def _literal(node: ast.expr, src: str) -> Any:
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError):
        raise PriorSyntaxError(
            f"prior arguments must be literals, got {ast.dump(node)} in {src!r}"
        ) from None


def parse_prior(name: str, expr: str) -> Dimension:
    """``parse_prior('lr', 'loguniform(1e-5, 1e-1)')`` → a typed Dimension.

    The expression is parsed as a single call with literal args/kwargs only —
    a restricted, safe replacement for the lineage's eval-against-scipy-names.
    """
    try:
        tree = ast.parse(expr.strip(), mode="eval")
    except SyntaxError as e:
        raise PriorSyntaxError(f"cannot parse prior {expr!r} for {name!r}: {e}") from None
    call = tree.body
    if not isinstance(call, ast.Call) or not isinstance(call.func, ast.Name):
        raise PriorSyntaxError(f"prior must be a simple call, got {expr!r}")
    prior = call.func.id.lower()
    args = [_literal(a, expr) for a in call.args]
    kwargs = {}
    for kw in call.keywords:
        if kw.arg is None:
            raise PriorSyntaxError(f"**kwargs not allowed in prior {expr!r}")
        kwargs[kw.arg] = _literal(kw.value, expr)

    shape = kwargs.pop("shape", None)
    if shape is not None:
        shape = tuple(shape) if isinstance(shape, (list, tuple)) else (int(shape),)
    default_value = kwargs.pop("default_value", None)
    common = dict(shape=shape, default_value=default_value)

    if prior == "fidelity":
        return Fidelity(name, prior, *args, **{**kwargs, **common})
    if prior == "choices":
        return Categorical(name, prior, *args, **{**kwargs, **common})
    if prior in _INT_PRIORS or (prior in _REAL_PRIORS and kwargs.pop("discrete", False)):
        if prior == "normal":
            raise PriorSyntaxError("normal prior cannot be discrete")
        return Integer(name, prior, *args, **{**kwargs, **common})
    if prior in _REAL_PRIORS:
        return Real(name, prior, *args, **{**kwargs, **common})
    raise PriorSyntaxError(
        f"unknown prior {prior!r} in {expr!r}; known: uniform, loguniform, "
        f"normal, randint, choices, fidelity"
    )


def build_space(spec: Mapping[str, str]) -> Space:
    """Build a Space from ``{name: 'prior(...)'}`` (configuration round-trip)."""
    space = Space()
    for name, expr in spec.items():
        expr = expr.strip()
        if expr.startswith("~"):
            expr = expr[1:]
        space.register(parse_prior(name, expr))
    return space


class CommandTemplate:
    """The user command with prior tokens replaced by fillable slots.

    ``format(params)`` materializes argv for one trial: a token parsed from
    ``--lr~'loguniform(...)'`` becomes ``--lr=0.0003``; a bare ``x~uniform(..)``
    token becomes ``0.42`` positionally prefixed by nothing (name is only the
    space key). Config-file templates are materialized separately via
    :meth:`materialize_config`.
    """

    def __init__(
        self,
        argv: List[str],
        slots: Dict[int, Tuple[str, str]],  # argv index -> (param name, dashes)
        config_path: Optional[str] = None,
        config_template: Optional[Dict[str, Any]] = None,
        config_slots: Optional[Dict[str, str]] = None,  # dotted path -> param name
        config_argv_index: Optional[int] = None,
        config_text: Optional[str] = None,        # generic TEXT template
        config_text_slots: Optional[Dict[str, str]] = None,  # token -> param
    ) -> None:
        self.argv = list(argv)
        self.slots = dict(slots)
        self.config_path = config_path
        self.config_template = config_template
        self.config_slots = dict(config_slots or {})
        self.config_argv_index = config_argv_index
        self.config_text = config_text
        self.config_text_slots = dict(config_text_slots or {})

    def format(self, params: Mapping[str, Any], config_out: Optional[str] = None) -> List[str]:
        out = list(self.argv)
        for idx, (pname, dashes) in self.slots.items():
            val = params[pname]
            out[idx] = f"{dashes}{pname}={val}" if dashes else str(val)
        if self.config_argv_index is not None and config_out is not None:
            out[self.config_argv_index] = config_out
        return out

    def materialize_config(self, params: Mapping[str, Any], out_path: str) -> None:
        """Write the user config file with priors replaced by concrete values."""
        if self.config_text is not None:
            # generic text template: ONE regex pass replacing whole
            # `name~prior(...)` tokens — sequential str.replace would let a
            # dim whose name suffixes another's (lr vs wlr) corrupt it
            slots = self.config_text_slots

            def fill(m: "re.Match[str]") -> str:
                pname = slots.get(m.group(0))
                return str(params[pname]) if pname is not None else m.group(0)

            with open(out_path, "w") as f:
                f.write(_TEXT_RE.sub(fill, self.config_text))
            return
        if self.config_template is None:
            raise RuntimeError("no config template attached")
        data = copy.deepcopy(self.config_template)
        for dotted, pname in self.config_slots.items():
            node = data
            *parents, leaf = dotted.split(".")
            for p in parents:
                node = node[p]
            node[leaf] = params[pname]
        infer_converter(out_path).generate(out_path, data)

    @property
    def has_config(self) -> bool:
        return self.config_template is not None or self.config_text is not None

    @property
    def param_names(self) -> List[str]:
        return (
            [n for n, _ in self.slots.values()]
            + list(self.config_slots.values())
            + list(self.config_text_slots.values())
        )


class SpaceBuilder:
    """Parse ``~prior`` markers out of user argv (and any config file in it)."""

    def build(self, user_argv: List[str]) -> Tuple[Space, CommandTemplate]:
        space = Space()
        slots: Dict[int, Tuple[str, str]] = {}
        config_path: Optional[str] = None
        config_template: Optional[Dict[str, Any]] = None
        config_slots: Dict[str, str] = {}
        config_argv_index: Optional[int] = None

        config_text: Optional[str] = None
        config_text_slots: Dict[str, str] = {}

        for i, tok in enumerate(user_argv):
            m = _TOKEN_RE.match(tok)
            if m:
                name = m.group("name")
                space.register(parse_prior(name, m.group("expr")))
                slots[i] = (name, m.group("dashes"))
                continue
            if tok.endswith((".yaml", ".yml", ".json")) and i > 0:
                found = self._scan_config(tok)
                if found:
                    if config_path is not None:
                        raise PriorSyntaxError(
                            f"two config templates carry priors "
                            f"({config_path!r} and {tok!r}); only one "
                            "config file per command may hold ~priors"
                        )
                    config_path = tok
                    config_argv_index = i
                    config_template, config_slots = found
                    for dotted, (pname, expr) in config_slots.items():
                        space.register(parse_prior(pname, expr))
                    config_slots = {d: p for d, (p, _) in config_slots.items()}
                    continue
            if i > 0:
                # generic fallback (a GenericConverter): ANY text
                # config carrying `name~prior(...)` tokens becomes a
                # textual template — ini/gin/toml/whatever, format
                # untouched. Deliberately NOT elif: a yaml-suffixed file
                # whose structured scan failed (list top level, bad syntax)
                # still gets the text scan instead of dropping its priors
                found_text = self._scan_text_config(tok)
                if found_text:
                    if config_path is not None:
                        raise PriorSyntaxError(
                            f"two config templates carry priors "
                            f"({config_path!r} and {tok!r}); only one "
                            "config file per command may hold ~priors"
                        )
                    config_path = tok
                    config_argv_index = i
                    config_text, text_priors = found_text
                    for pname, (token, expr) in text_priors.items():
                        space.register(parse_prior(pname, expr))
                        config_text_slots[token] = pname

        template = CommandTemplate(
            user_argv, slots, config_path, config_template, config_slots,
            config_argv_index, config_text, config_text_slots,
        )
        return space, template

    @staticmethod
    def _scan_text_config(path: str):
        """Generic text template: find ``name~prior(...)`` tokens in a file.

        Returns (raw text, {param name: (full token, prior expr)}) or None
        when the path isn't a readable modest-size text file with tokens.
        Script sources (.py/.sh) are excluded — the script is the thing
        being RUN, not a config to rewrite.
        """
        if path.endswith((".py", ".sh")) or not os.path.isfile(path):
            return None
        try:
            if os.path.getsize(path) > 1 << 20:
                return None
            with open(path, encoding="utf-8") as f:
                text = f.read()
        except (OSError, UnicodeDecodeError):
            return None
        found: Dict[str, Tuple[str, str]] = {}
        for m in _TEXT_RE.finditer(text):
            name, expr, token = m.group("name"), m.group("expr"), m.group(0)
            # only tokens that fully PARSE as known priors turn a file into
            # a template: prose like "see y~f(x)" or "lr~uniform(low, high)"
            # in an inert data/doc file must stay inert
            if expr.split("(", 1)[0].lower() not in _KNOWN_PRIORS:
                continue
            try:
                parse_prior(name, expr)
            except PriorSyntaxError:
                continue
            if name in found and found[name][1] != expr:
                raise PriorSyntaxError(
                    f"{path}: dimension {name!r} declared twice with "
                    f"different priors ({found[name][1]!r} vs {expr!r})"
                )
            found[name] = (token, expr)
        return (text, found) if found else None

    @staticmethod
    def _scan_config(path: str):
        """Parse a config file; collect string values matching the DSL.

        Returns (template dict, {dotted path: (param name, prior expr)}) or
        None if the file can't be read as a mapping / has no priors.
        """
        try:
            data = infer_converter(path).parse(path)
        except Exception:
            return None
        if not isinstance(data, dict):
            return None
        found: Dict[str, Tuple[str, str]] = {}

        def walk(node: Any, prefix: str) -> None:
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{prefix}.{k}" if prefix else str(k))
            elif isinstance(node, str):
                m = _TOKEN_RE.match(node.strip())
                if m:
                    # inside a config file the value may be written either as
                    # 'name~prior(...)' or just '~prior(...)'; the key path
                    # names the dimension when the name part is absent.
                    found[prefix] = (m.group("name"), m.group("expr"))
                elif node.strip().startswith("~"):
                    expr = node.strip()[1:]
                    pname = prefix.split(".")[-1]
                    found[prefix] = (pname, expr)

        walk(data, "")
        if not found:
            return None
        return data, found
