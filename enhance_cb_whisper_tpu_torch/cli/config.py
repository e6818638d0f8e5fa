"""YAML config loading with jsonargparse-style dotted overrides (a copy of
enhance_cb_whisper_tpu/cli/config.py, which needs only yaml).

Keeps the reference's config surface (class_path/init_args blocks,
``[PLACEHOLDER]`` markers for required user inputs) without Lightning:
configs parse to plain nested dicts; the CLI consumes the ``init_args`` it
understands.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import yaml

_PLACEHOLDER = re.compile(r"^\[.*\]$")
# `[NAME]` or `[NAME(annotation/of/choices)]` — the reference's required-input
# markers (README.md:79,97,143)
_PLACEHOLDER_TOKEN = re.compile(r"\[([A-Za-z0-9_]+)(\([^\[\]]*\))?\]")


def _scalar_to_yaml(value: Any) -> str:
    text = yaml.safe_dump(value, default_flow_style=True).strip()
    if text.endswith("\n..."):
        text = text[: -len("\n...")].strip()
    return text


def fill_placeholders_text(raw: str, values: Dict[str, Any]) -> str:
    """Textual ``[PLACEHOLDER]`` substitution on a raw YAML document.

    The reference marks required user inputs as ``[LIKE_THIS]`` and
    sometimes annotates them with text that is not valid YAML (e.g.
    ``num_domains: [NUM_DOMAINS] where :=2 if ...``,
    reference src/configs/train.yaml:141 — the file does not even parse
    until the user fills it in).  Filling BEFORE parsing is therefore the
    reference's own usage contract (README.md:79,97,143); this helper
    automates it so the reference's verbatim config files run through
    ``run_cli`` (``--set NAME=value`` on the command line).  Annotation
    tails (`` -- where ...`` / `` where :=...``) are stripped."""

    def sub(m: "re.Match[str]") -> str:
        name = m.group(1)
        if name in values:
            return _scalar_to_yaml(values[name])
        return m.group(0)

    out = _PLACEHOLDER_TOKEN.sub(sub, raw)
    out = re.sub(r"[ \t]+--[ \t]+where[ \t].*$", "", out, flags=re.M)
    out = re.sub(r"[ \t]+where[ \t]+:=.*$", "", out, flags=re.M)
    return out


def load_config(path: str, placeholders: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    with open(path) as f:
        raw = f.read()
    if placeholders:
        raw = fill_placeholders_text(raw, placeholders)
    return yaml.safe_load(raw)


def _parse_value(text: str) -> Any:
    return yaml.safe_load(text)


def apply_overrides(config: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """``--a.b.c value`` pairs → nested assignment."""
    i = 0
    while i < len(overrides):
        key = overrides[i]
        assert key.startswith("--"), f"expected --dotted.key, got {key}"
        assert i + 1 < len(overrides), f"override {key} is missing its value"
        key = key[2:]
        value = _parse_value(overrides[i + 1])
        node = config
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
        i += 2
    return config


def check_placeholders(config: Any, path: str = "") -> List[str]:
    """Find remaining [PLACEHOLDER] values the user must fill in."""
    found = []
    if isinstance(config, dict):
        for k, v in config.items():
            found += check_placeholders(v, f"{path}.{k}" if path else k)
    elif isinstance(config, list):
        # an UNFILLED `key: [NAME]` marker parses as the YAML list ["NAME"]
        # once fill_placeholders_text strips its annotation tail — flag
        # single-element all-caps-identifier lists as leftover placeholders
        if (
            len(config) == 1
            and isinstance(config[0], str)
            and re.fullmatch(r"[A-Z][A-Z0-9_]*", config[0])
        ):
            found.append(f"{path} = [{config[0]}]")
        for i, v in enumerate(config):
            found += check_placeholders(v, f"{path}[{i}]")
    elif isinstance(config, str) and _PLACEHOLDER.match(config.strip()):
        found.append(f"{path} = {config}")
    return found


def get(config: Dict[str, Any], dotted: str, default=None):
    node = config
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def filter_kwargs(init_args: Optional[Dict[str, Any]], cls) -> Dict[str, Any]:
    """Keep only kwargs the dataclass/callable accepts."""
    import dataclasses
    import inspect

    if init_args is None:
        return {}
    if dataclasses.is_dataclass(cls):
        names = {f.name for f in dataclasses.fields(cls)}
    else:
        names = set(inspect.signature(cls).parameters)
    return {k: v for k, v in init_args.items() if k in names}
