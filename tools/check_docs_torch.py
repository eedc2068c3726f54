#!/usr/bin/env python
"""Docs check of the PyTorch / H100 port (`src/repro_torch/`), the twin
of ``tools/check_docs.py`` (which checks the docs against the JAX
package only).  It reads README.md's "PyTorch / H100 port" section and
the port's part of ``.claude/skills/verify/SKILL.md`` (from its
"PyTorch / H100 port" heading on), and fails when they name something
that does not exist:

* a file path (``launch/train.py``, ``tests/test_torch_lm.py``) must
  exist under the repository root or under ``src/repro_torch/`` (an
  absolute path, a command's output such as ``/tmp/lm.jsonl``, is not
  a reference);
* a ``repro_torch.*`` dotted reference must resolve: its longest prefix
  that is a module file or package under ``src/``, and the next
  component, if any, a name that module (or package ``__init__``)
  defines or a submodule;
* a ``--flag`` in a command that runs one of the port's entry points
  (``repro_torch.launch.*``, ``repro_torch.examples.*``,
  ``repro_torch.quickstart``, ``chip_smoke.py``, ``ab_rounds.py``,
  ``remat_host.py``, ``tools/ab_kernel_times.py``), in a fenced block or an inline code
  span, must appear as ``"--flag"`` in that entry point's source.

Standard library and text matching only: it imports nothing of the
package.  Usage (exit 0 when clean, 1 with the list of faults):

    python tools/check_docs_torch.py
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
README = ROOT / "README.md"
SKILL = ROOT / ".claude" / "skills" / "verify" / "SKILL.md"
#: the heading that opens the port's part of each document
HEADING = "## PyTorch / H100 port"

PATH_RE = re.compile(r"[\w./-]+/[\w.-]+\.(?:py|md|json|jsonl|cu|cuh|ini)\b")
MODULE_RE = re.compile(r"\brepro_torch(?:\.\w+)+")
FLAG_RE = re.compile(r"(?<![-\w])--([a-z][\w-]*)")
#: a command's entry point: a module run with ``-m`` or a script
ENTRY_RE = re.compile(
    r"-m\s+(repro_torch\.(?:launch|examples)\.\w+|repro_torch\.quickstart)"
    r"\b|\b(chip_smoke\.py|ab_rounds\.py|remat_host\.py"
    r"|tools/ab_kernel_times\.py)\b")
#: a top-level definition of ``name`` in a module's source
DEFINES = (r"^(?:def|class)\s+{0}\b|^{0}\s*[:=]"
           r"|^\s*(?:from\s+\S+\s+)?import\s.*\b{0}\b")


def section(text: str, heading: str = HEADING) -> str:
    """The part of ``text`` from ``heading`` to the next heading of the
    same level (the end of the text if none)."""
    start = text.find(heading)
    if start < 0:
        return ""
    end = text.find("\n## ", start + len(heading))
    return text[start:] if end < 0 else text[start:end]


def path_exists(p: str) -> bool:
    p = p.lstrip("./")
    return (ROOT / p).exists() or (PORT / p).exists()


def module_resolves(dotted: str) -> bool:
    """The longest prefix of ``dotted`` that is a module file or package
    under ``src/``; the component after it, if any, defined there (a
    name of the module, of the package's ``__init__``, or a
    submodule)."""
    parts = dotted.split(".")
    for end in range(len(parts), 1, -1):
        base = SRC.joinpath(*parts[:end])
        if base.with_suffix(".py").is_file():
            source = base.with_suffix(".py")
        elif base.is_dir():
            source = base / "__init__.py"
        else:
            continue
        if end == len(parts):
            return True
        name = parts[end]
        if base.is_dir() and ((base / name).is_dir()
                              or (base / f"{name}.py").is_file()):
            return True
        text = source.read_text() if source.is_file() else ""
        return re.search(DEFINES.format(re.escape(name)), text,
                         re.M) is not None
    return False


def entry_source(match: re.Match) -> Path:
    module, script = match.groups()
    if module:
        return SRC.joinpath(*module.split(".")).with_suffix(".py")
    return ROOT / script


def commands(text: str):
    """Command lines of the fenced blocks (backslash continuations
    joined), then the inline code spans outside them (a span may wrap
    across lines)."""
    fenced = re.compile(r"```\w*\n(.*?)```", re.S)
    for block in fenced.findall(text):
        for line in block.replace("\\\n", " ").splitlines():
            if line.strip() and not line.strip().startswith("#"):
                yield line.strip()
    for span in re.findall(r"`([^`]+)`", fenced.sub("", text)):
        yield " ".join(span.split())


def check(name: str, text: str, errors: list) -> None:
    for m in PATH_RE.finditer(text):
        if not m.group(0).startswith("/") and not path_exists(m.group(0)):
            errors.append(f"{name}: references missing path "
                          f"`{m.group(0)}`")
    for m in MODULE_RE.finditer(text):
        if not module_resolves(m.group(0)):
            errors.append(f"{name}: references missing module or name "
                          f"`{m.group(0)}`")
    for cmd in commands(text):
        entry = ENTRY_RE.search(cmd)
        if entry is None:
            continue
        src_path = entry_source(entry)
        if not src_path.is_file():
            errors.append(f"{name}: `{cmd}` runs a missing entry point")
            continue
        src = src_path.read_text()
        for flag in FLAG_RE.findall(cmd[entry.end():]):
            if f'"--{flag}"' not in src:
                errors.append(f"{name}: flag `--{flag}` is not defined in "
                              f"{src_path.relative_to(ROOT)}")


def main() -> int:
    errors: list = []
    for doc in (README, SKILL):
        text = section(doc.read_text()) if doc.is_file() else ""
        if not text:
            errors.append(f"{doc}: no '{HEADING}' section")
            continue
        check(doc.name, text, errors)
    if errors:
        print(f"docs-check (port): {len(errors)} stale reference(s)")
        for e in errors:
            print(f"  {e}")
        return 1
    print("docs-check (port): README.md and SKILL.md port sections clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
