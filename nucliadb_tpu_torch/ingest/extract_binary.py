"""Dependency-free extraction for binary document formats.

The port's copy of ``nucliadb_tpu/ingest/extract_binary.py``,
kept verbatim: the port imports nothing of the JAX package.

Closes most of the "binary formats need an external processing engine" gap
(ingest/extract.py) with stdlib-only parsers:

- Office Open XML (docx/pptx/xlsx): zip containers of XML — ``zipfile`` +
  ``xml.etree`` pull the text runs (w:t / a:t / shared strings + inline
  cell strings), matching what the reference's processing service returns
  as the extracted body for these formats.
- RTF: control-word stripper with the standard destinations skipped
  (fonttbl, stylesheet, pict, ...) and \\'hh escapes decoded.
- PDF: a from-scratch reader for the common case — Flate (zlib) or plain
  content streams, text shown with Tj / TJ / ' / " operators, literal and
  hex strings, octal escapes. CID/Type0-encoded PDFs (where the bytes are
  glyph ids, not character codes) come out garbled and are rejected by a
  printable-ratio check — those still need the external processing engine.

Everything returns None rather than raising: extraction is best-effort and
an unextractable upload simply stays a stored blob (the reference behaves
the same while processing is pending/unavailable).
"""

from __future__ import annotations

import io
import re
import zipfile
import zlib
from typing import Optional
from xml.etree import ElementTree

_W = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"
_A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"
_S = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def docx_text(data: bytes) -> Optional[str]:
    try:
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            xml = z.read("word/document.xml")
        root = ElementTree.fromstring(xml)
        paras = []
        for p in root.iter(f"{_W}p"):
            runs = [t.text or "" for t in p.iter(f"{_W}t")]
            text = "".join(runs).strip()
            if text:
                paras.append(text)
        return "\n".join(paras) or None
    except Exception:
        return None


def pptx_text(data: bytes) -> Optional[str]:
    try:
        out = []
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            slides = sorted(
                n for n in z.namelist()
                if re.fullmatch(r"ppt/slides/slide\d+\.xml", n)
            )
            for name in slides:
                root = ElementTree.fromstring(z.read(name))
                texts = [t.text or "" for t in root.iter(f"{_A}t")]
                text = "\n".join(s.strip() for s in texts if s.strip())
                if text:
                    out.append(text)
        return "\n\n".join(out) or None
    except Exception:
        return None


def xlsx_text(data: bytes) -> Optional[str]:
    try:
        out = []
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            shared: list[str] = []
            if "xl/sharedStrings.xml" in z.namelist():
                root = ElementTree.fromstring(z.read("xl/sharedStrings.xml"))
                for si in root.iter(f"{_S}si"):
                    shared.append("".join(t.text or "" for t in si.iter(f"{_S}t")))
            sheets = sorted(
                n for n in z.namelist()
                if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)
            )
            for name in sheets:
                root = ElementTree.fromstring(z.read(name))
                cells = []
                for c in root.iter(f"{_S}c"):
                    v = c.find(f"{_S}v")
                    if v is None or v.text is None:
                        # inline strings live under is/t
                        t = c.find(f"{_S}is/{_S}t")
                        if t is not None and t.text:
                            cells.append(t.text)
                        continue
                    if c.get("t") == "s":
                        try:
                            cells.append(shared[int(v.text)])
                        except (ValueError, IndexError):
                            pass
                    else:
                        cells.append(v.text)
                if cells:
                    out.append(" ".join(cells))
        return "\n".join(out) or None
    except Exception:
        return None


_RTF_SKIP_DESTS = {
    "fonttbl", "colortbl", "stylesheet", "info", "pict", "object",
    "header", "footer", "xmlopen", "themedata", "colorschememapping",
    "latentstyles", "datastore",
}


def rtf_text(data: bytes) -> Optional[str]:
    try:
        s = data.decode("latin-1", errors="replace")
        out: list[str] = []
        skip_depth = 0  # depth of the group being skipped (0 = not skipping)
        depth = 0
        uc_skip = 1  # \ucN: ANSI fallback chars following each \uN (default 1)
        uc_stack: list[int] = []  # \uc is GROUP-scoped: restored at "}"
        i = 0
        n = len(s)
        while i < n:
            ch = s[i]
            if ch == "{":
                depth += 1
                uc_stack.append(uc_skip)
                i += 1
            elif ch == "}":
                if skip_depth and depth == skip_depth:
                    skip_depth = 0
                depth -= 1
                if uc_stack:
                    uc_skip = uc_stack.pop()
                i += 1
            elif ch == "\\":
                m = re.match(r"\\([a-zA-Z]+)(-?\d+)? ?", s[i:])
                if m:
                    word = m.group(1)
                    if not skip_depth and word in _RTF_SKIP_DESTS:
                        skip_depth = depth
                    elif word == "par" or word == "line":
                        if not skip_depth:
                            out.append("\n")
                    elif word == "tab":
                        if not skip_depth:
                            out.append("\t")
                    elif word == "uc" and m.group(2) is not None:
                        uc_skip = max(0, int(m.group(2)))
                    elif word == "u" and m.group(2) is not None:
                        if not skip_depth:
                            out.append(chr(int(m.group(2)) & 0xFFFF))
                        i += m.end()
                        # the \uN scalar is followed by \ucN ANSI fallback
                        # chars (plain, \'xx hex, or escaped literals) that
                        # must NOT be emitted too; CR/LF line wraps between
                        # them are not characters and don't count
                        for _ in range(uc_skip):
                            while s[i : i + 1] in ("\r", "\n"):
                                i += 1
                            if s[i : i + 2] == "\\'":
                                i += 4
                            elif s[i : i + 1] == "\\" and s[i + 1 : i + 2] in "{}\\":
                                i += 2  # escaped-literal fallback
                            elif i < n and s[i] not in "{}\\":
                                i += 1
                            else:
                                break
                        continue
                    i += m.end()
                elif s[i + 1 : i + 2] == "'":
                    if not skip_depth:
                        try:
                            out.append(bytes([int(s[i + 2 : i + 4], 16)]).decode("cp1252", "replace"))
                        except ValueError:
                            pass
                    i += 4
                else:  # escaped literal \{ \} \\
                    if not skip_depth and i + 1 < n:
                        out.append(s[i + 1])
                    i += 2
            else:
                if not skip_depth and ch not in "\r\n":
                    out.append(ch)
                i += 1
        text = "".join(out)
        lines = [" ".join(l.split()) for l in text.splitlines()]
        return "\n".join(l for l in lines if l) or None
    except Exception:
        return None


# ---- PDF ------------------------------------------------------------------

_PDF_STREAM_RE = re.compile(rb"stream\r?\n(.*?)(?:\r?\n)?endstream", re.DOTALL)


def _pdf_decode_string(raw: bytes) -> str:
    """A PDF literal string body -> text (octal + escape handling)."""
    out = []
    i = 0
    while i < len(raw):
        b = raw[i]
        if b == 0x5C:  # backslash
            nxt = raw[i + 1 : i + 2]
            if nxt.isdigit():
                oct_digits = raw[i + 1 : i + 4]
                m = re.match(rb"[0-7]{1,3}", oct_digits)
                out.append(int(m.group(), 8))
                i += 1 + m.end()
                continue
            esc = {b"n": 10, b"r": 13, b"t": 9, b"b": 8, b"f": 12}.get(nxt)
            out.append(esc if esc is not None else (nxt[0] if nxt else 0))
            i += 2
        else:
            out.append(b)
            i += 1
    return bytes(out).decode("cp1252", errors="replace")


_TEXT_SHOW_RE = re.compile(
    rb"\((?P<lit>(?:[^()\\]|\\.)*)\)\s*(?:Tj|')"  # (..) Tj  /  (..) '
    rb"|<(?P<hex>[0-9A-Fa-f\s]+)>\s*Tj"  # <hex> Tj
    rb"|\[(?P<arr>(?:[^\[\]\\]|\\.)*)\]\s*TJ",  # [ .. ] TJ
    re.DOTALL,
)
_ARR_STR_RE = re.compile(rb"\((?:[^()\\]|\\.)*\)|<[0-9A-Fa-f\s]+>", re.DOTALL)
_NEWLINE_OPS_RE = re.compile(rb"\b(?:Td|TD|T\*)\b")


def _pdf_stream_text(content: bytes) -> list[str]:
    chunks: list[str] = []
    for m in _TEXT_SHOW_RE.finditer(content):
        if m.group("lit") is not None:
            chunks.append(_pdf_decode_string(m.group("lit")))
        elif m.group("hex") is not None:
            h = re.sub(rb"\s", b"", m.group("hex"))
            if len(h) % 2:
                h += b"0"
            chunks.append(bytes.fromhex(h.decode()).decode("cp1252", "replace"))
        else:
            for sm in _ARR_STR_RE.finditer(m.group("arr")):
                tok = sm.group()
                if tok.startswith(b"("):
                    chunks.append(_pdf_decode_string(tok[1:-1]))
                else:
                    h = re.sub(rb"\s", b"", tok[1:-1])
                    if len(h) % 2:
                        h += b"0"
                    chunks.append(bytes.fromhex(h.decode()).decode("cp1252", "replace"))
        chunks.append(" ")
    return chunks


def pdf_text(data: bytes) -> Optional[str]:
    """Best-effort text of a PDF: every Flate/plain stream is scanned for
    text-show operators. Garbled output (CID fonts) is rejected."""
    try:
        if not data.startswith(b"%PDF"):
            return None
        chunks: list[str] = []
        for m in _PDF_STREAM_RE.finditer(data):
            body = m.group(1)
            if b"Tj" not in body and b"TJ" not in body:
                try:
                    body = zlib.decompress(body)
                except zlib.error:
                    continue
            if b"Tj" not in body and b"TJ" not in body:
                continue
            chunks.extend(_pdf_stream_text(body))
        text = "".join(chunks)
        text = re.sub(r"[ \t]+", " ", text)
        lines = [l.strip() for l in text.splitlines()]
        text = "\n".join(l for l in lines if l).strip()
        if not text:
            return None
        # CID/Type0 guard: reject mostly-unprintable output
        printable = sum(c.isprintable() or c in "\n\t" for c in text)
        if printable / len(text) < 0.85:
            return None
        return text
    except Exception:
        return None
