"""File and tokenization utilities.

Behavioral parity with the reference's ``com/FileUtil.java`` (see SURVEY.md §2.1 #4):
``readLines`` / ``writeLines`` / ``tokenizeAndLowerCase`` / ``mkdir``.  The reference
tokenizes with ``java.util.StringTokenizer`` — i.e. a split on runs of the default
delimiter set ``" \t\n\r\f"`` with empty tokens dropped — then lowercases and trims.
Note Python's argless ``str.split()`` is *broader* than that (it also splits on
``\x0b`` and Unicode whitespace such as U+00A0); ``_split_java`` below exists
precisely because of that difference.  Likewise Java ``String.trim()`` strips all
leading/trailing chars with code point <= U+0020 (not Unicode whitespace), which
``_java_trim`` reproduces.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List

# StringTokenizer's default delimiters: space, tab, newline, carriage return, form feed.
_JAVA_DELIMS = " \t\n\r\x0c"


def read_lines(path: str | Path) -> List[str]:
    """Read a text file into a list of lines (reference ``FileUtil.readLines``).

    Java's BufferedReader.readLine strips the terminator; so do we.  Decoding is
    UTF-8 with replacement so a stray byte never crashes ingestion.
    """
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return [line.rstrip("\n") for line in f]


def write_lines(path: str | Path, lines: Iterable[object]) -> None:
    """Write items one per line (reference ``FileUtil.writeLines``)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w", encoding="utf-8") as f:
        for item in lines:
            f.write(f"{item}\n")


def tokenize(line: str) -> List[str]:
    """Whitespace tokenize, preserving case (reference ``FileUtil.tokenize``)."""
    return _split_java(line)


def tokenize_and_lowercase(line: str) -> List[str]:
    """Whitespace tokenize + lowercase + trim (``FileUtil.tokenizeAndLowerCase``).

    Lowercasing uses ``str.lower()`` — locale-independent, matching Java
    ``toLowerCase()`` under the root locale for the ASCII corpora this pipeline
    targets.  Trimming is Java ``trim()`` semantics (see ``_java_trim``).
    """
    return [_java_trim(tok.lower()) for tok in _split_java(line)]


def _java_trim(s: str) -> str:
    """Java ``String.trim()``: strip leading/trailing chars with ord <= 0x20.

    Differs from ``str.strip()`` both ways: trim removes control chars like
    ``\\x01`` (strip keeps them) and keeps Unicode whitespace like U+00A0
    (strip removes it).
    """
    start, end = 0, len(s)
    while start < end and ord(s[start]) <= 0x20:
        start += 1
    while end > start and ord(s[end - 1]) <= 0x20:
        end -= 1
    return s[start:end]


def _split_java(line: str) -> List[str]:
    # Split on runs of the StringTokenizer delimiter set, dropping empties.
    out: List[str] = []
    cur: list[str] = []
    for ch in line:
        if ch in _JAVA_DELIMS:
            if cur:
                out.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def mkdir(path: str | Path) -> None:
    """Create a directory tree if missing (reference ``FileUtil.mkdir``)."""
    Path(path).mkdir(parents=True, exist_ok=True)
