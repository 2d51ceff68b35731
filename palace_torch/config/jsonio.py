"""JSON-with-extensions preprocessing for configuration files.

The configuration format supports two extensions over standard JSON,
matching the reference solver (reference: docs/src/config/config.md:31-38,
palace/utils/iodata.cpp:71-160):

- C (``/* */``) and C++ (``// ...``) style comments.
- Integer range expansion inside arrays: ``[1, 3-5, 8]`` -> ``[1,3,4,5,8]``.

Duplicate keys within an object are an error.

Copied from palace_tpu/config/jsonio.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import json
import re


def strip_comments(text: str) -> str:
    """Remove // and /* */ comments, preserving string literals."""
    out = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == '"':
            j = i + 1
            while j < n:
                if text[j] == "\\":
                    j += 2
                    continue
                if text[j] == '"':
                    break
                j += 1
            out.append(text[i : j + 1])
            i = j + 1
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            j = text.find("\n", i)
            i = n if j < 0 else j
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            if j < 0:
                raise ValueError("unterminated /* comment in configuration file")
            i = j + 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


_RANGE_RE = re.compile(r"(\d+)\s*-\s*(\d+)")


def expand_ranges(text: str) -> str:
    """Expand integer ranges ``a-b`` appearing inside [...] arrays."""
    out = []
    i, n = 0, len(text)
    depth = 0
    while i < n:
        c = text[i]
        if c == '"':
            j = i + 1
            while j < n:
                if text[j] == "\\":
                    j += 2
                    continue
                if text[j] == '"':
                    break
                j += 1
            out.append(text[i : j + 1])
            i = j + 1
            continue
        if c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
        if depth > 0 and c.isdigit():
            m = _RANGE_RE.match(text, i)
            if m:
                a, b = int(m.group(1)), int(m.group(2))
                if b < a:
                    raise ValueError(f"invalid integer range {a}-{b} in configuration")
                out.append(",".join(str(v) for v in range(a, b + 1)))
                i = m.end()
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _reject_duplicate_keys(pairs):
    d = {}
    for k, v in pairs:
        if k in d:
            raise ValueError(f"duplicate key '{k}' in configuration object")
        d[k] = v
    return d


_TRAILING_COMMA_RE = re.compile(r",(\s*[}\]])")


def strip_trailing_commas(text: str) -> str:
    """Remove trailing commas before } or ] (outside string literals)."""
    out = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == '"':
            j = i + 1
            while j < n:
                if text[j] == "\\":
                    j += 2
                    continue
                if text[j] == '"':
                    break
                j += 1
            out.append(text[i : j + 1])
            i = j + 1
            continue
        if c == ",":
            j = i + 1
            while j < n and text[j] in " \t\r\n":
                j += 1
            if j < n and text[j] in "}]":
                i += 1
                continue
        out.append(c)
        i += 1
    return "".join(out)


def loads(text: str) -> dict:
    """Parse configuration JSON with comments and range expansion."""
    return json.loads(
        expand_ranges(strip_trailing_commas(strip_comments(text))),
        object_pairs_hook=_reject_duplicate_keys,
    )


def load(path) -> dict:
    with open(path, "r") as f:
        return loads(f.read())
