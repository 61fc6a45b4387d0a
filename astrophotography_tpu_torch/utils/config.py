"""Typed YAML application configuration with macro substitution.

Equivalent of the reference YamlConfig/_AttrDict
(reference core/config.py:16-121): attribute-style access into nested
dicts, multi-file load with later files overriding earlier ones, and
``%key;`` macro substitution where ``key`` is a dotted path into the
already-merged configuration.  ``yaml`` is imported when a file is
loaded, so the package imports without it.
"""

from __future__ import annotations

import re
from typing import Any, Iterable, Mapping, Union

_MACRO_RE = re.compile(r"%([A-Za-z0-9_.]+);")


class AttrDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, AttrDict):
            value = AttrDict(value)
        super().__setitem__(key, value)

    @classmethod
    def wrap(cls, data: Mapping) -> "AttrDict":
        out = cls()
        for k, v in data.items():
            out[k] = v
        return out


def _deep_merge(base: AttrDict, extra: Mapping) -> None:
    for k, v in extra.items():
        if k in base and isinstance(base[k], Mapping) and isinstance(v, Mapping):
            _deep_merge(base[k], v)
        else:
            base[k] = v


def _resolve_path(root: Mapping, dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        node = node[part]
    return node


class YamlConfig(AttrDict):
    """Application config: YAML file(s) merged + ``%key;`` macros expanded."""

    def load(self, paths: Union[str, Iterable[str]]) -> "YamlConfig":
        import yaml

        if isinstance(paths, str):
            paths = [paths]
        for path in paths:
            with open(path, "r") as fh:
                data = yaml.safe_load(fh) or {}
            if not isinstance(data, Mapping):
                raise ValueError(f"config file {path!r} must contain a mapping")
            _deep_merge(self, data)
        self._expand_macros(self)
        return self

    def _expand_macros(self, node: Any) -> Any:
        if isinstance(node, Mapping):
            for k in list(node.keys()):
                node[k] = self._expand_macros(node[k])
            return node
        if isinstance(node, list):
            return [self._expand_macros(v) for v in node]
        if isinstance(node, str):
            def sub(match: "re.Match[str]") -> str:
                return str(_resolve_path(self, match.group(1)))

            prev = None
            while prev != node:  # nested macros resolve transitively
                prev = node
                node = _MACRO_RE.sub(sub, node)
            return node
        return node


#: Global configuration singleton (reference core/config.py:124).
config = YamlConfig()
