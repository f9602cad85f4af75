"""Local file-text extraction for uploaded blob fields.

The port's copy of ``nucliadb_tpu/ingest/extract.py``,
kept verbatim: the port imports nothing of the JAX package.

The reference ships uploaded files to the Nuclia processing service, which
returns extracted text that lands as extracted/computed fields and gets
indexed (writer upload -> processing -> BrokerMessage; see SURVEY §3.1 and
reference writer/api/v1/upload.py store_file_on_nuclia_db). An embedded
deployment has no processing service, so this module extracts text locally
for the self-describing formats (plain text, markdown, HTML, JSON, CSV) and
attaches it to the resource as a text field — making uploads searchable out
of the box. Binary documents (docx/pptx/xlsx/rtf and the common PDF cases)
extract through the stdlib-only parsers in extract_binary.py; exotic PDFs
(CID fonts), images and audio still need an external processing engine and
pass through unextracted (the seam: PredictEngine-style plug).
"""

from __future__ import annotations

import json
from html.parser import HTMLParser
from typing import Optional

MAX_EXTRACT_BYTES = 16 * 1024 * 1024

_TEXT_TYPES = {
    "text/plain": "PLAIN",
    "text/markdown": "MARKDOWN",
    "text/x-markdown": "MARKDOWN",
    "text/csv": "PLAIN",
    "application/json": "JSON",
    "text/html": "HTML",
    "application/xhtml+xml": "HTML",
}

_BINARY_TYPES = {
    "application/pdf": "PDF",
    "application/vnd.openxmlformats-officedocument.wordprocessingml.document": "DOCX",
    "application/vnd.openxmlformats-officedocument.presentationml.presentation": "PPTX",
    "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet": "XLSX",
    "application/rtf": "RTF",
    "text/rtf": "RTF",
}

_EXT_TYPES = {
    ".txt": "text/plain",
    ".md": "text/markdown",
    ".markdown": "text/markdown",
    ".csv": "text/csv",
    ".json": "application/json",
    ".html": "text/html",
    ".htm": "text/html",
    ".pdf": "application/pdf",
    ".docx": "application/vnd.openxmlformats-officedocument.wordprocessingml.document",
    ".pptx": "application/vnd.openxmlformats-officedocument.presentationml.presentation",
    ".xlsx": "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet",
    ".rtf": "application/rtf",
}


class _HTMLText(HTMLParser):
    _SKIP = {"script", "style", "head", "template"}
    _BREAK = {"p", "br", "div", "li", "tr", "h1", "h2", "h3", "h4", "h5", "h6"}

    def __init__(self) -> None:
        super().__init__()
        self.chunks: list[str] = []
        self._skipping = 0

    def handle_starttag(self, tag, attrs):
        if tag in self._SKIP:
            self._skipping += 1
        elif tag in self._BREAK:
            self.chunks.append("\n")

    def handle_endtag(self, tag):
        if tag in self._SKIP and self._skipping:
            self._skipping -= 1

    def handle_data(self, data):
        if not self._skipping:
            self.chunks.append(data)

    def text(self) -> str:
        raw = "".join(self.chunks)
        lines = [" ".join(line.split()) for line in raw.splitlines()]
        return "\n".join(line for line in lines if line)


def _json_text(data: bytes) -> str:
    def walk(node, out: list[str]):
        if isinstance(node, str):
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v, out)
        elif isinstance(node, list):
            for v in node:
                walk(v, out)

    out: list[str] = []
    walk(json.loads(data), out)
    return "\n".join(out)


def sniff_content_type(filename: str, content_type: str) -> str:
    """Resolve a usable content type from the declared one or the
    filename extension."""
    ct = (content_type or "").split(";")[0].strip().lower()
    if ct in _TEXT_TYPES or ct in _BINARY_TYPES:
        return ct
    dot = filename.rfind(".")
    if dot >= 0:
        return _EXT_TYPES.get(filename[dot:].lower(), ct)
    return ct


def extract_text(filename: str, content_type: str, data: bytes) -> Optional[str]:
    """Returns extracted plain text, or None when the format needs an
    external processing engine."""
    if len(data) > MAX_EXTRACT_BYTES:
        return None
    ct = sniff_content_type(filename, content_type)
    binary_kind = _BINARY_TYPES.get(ct)
    if binary_kind is not None:
        from . import extract_binary as xb

        return {
            "PDF": xb.pdf_text,
            "DOCX": xb.docx_text,
            "PPTX": xb.pptx_text,
            "XLSX": xb.xlsx_text,
            "RTF": xb.rtf_text,
        }[binary_kind](data)
    kind = _TEXT_TYPES.get(ct)
    if kind is None:
        return None
    try:
        if kind == "HTML":
            parser = _HTMLText()
            parser.feed(data.decode("utf-8", errors="replace"))
            return parser.text() or None
        if kind == "JSON":
            return _json_text(data) or None
        return data.decode("utf-8", errors="replace").strip() or None
    except Exception:
        return None
