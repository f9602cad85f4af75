"""The scenarios of ``tests/test_extract_binary.py`` on the port: the port's extractors and a CPU node.

The reference file's own docstring:

Binary-format extraction: fixtures are synthesized with stdlib writers
(zipfile + xml for OOXML, handwritten PDF/RTF bytes), then extracted by the
dependency-free parsers in ingest/extract_binary.py."""

import io
import zipfile
import zlib

from nucliadb_tpu_torch.ingest.extract import extract_text, sniff_content_type


def make_docx(paragraphs):
    buf = io.BytesIO()
    body = "".join(
        f"<w:p><w:r><w:t>{p}</w:t></w:r></w:p>" for p in paragraphs
    )
    doc = (
        '<?xml version="1.0"?>'
        '<w:document xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/main">'
        f"<w:body>{body}</w:body></w:document>"
    )
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("[Content_Types].xml", "<Types/>")
        z.writestr("word/document.xml", doc)
    return buf.getvalue()


def make_pptx(slides):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("[Content_Types].xml", "<Types/>")
        for i, texts in enumerate(slides, start=1):
            runs = "".join(f"<a:t>{t}</a:t>" for t in texts)
            z.writestr(
                f"ppt/slides/slide{i}.xml",
                '<p:sld xmlns:p="x" '
                'xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main">'
                f"{runs}</p:sld>",
            )
    return buf.getvalue()


def make_xlsx(rows, shared):
    buf = io.BytesIO()
    ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    sst = "".join(f"<si><t>{s}</t></si>" for s in shared)
    cells = []
    for value, kind in rows:
        if kind == "s":
            cells.append(f'<c t="s"><v>{value}</v></c>')
        else:
            cells.append(f"<c><v>{value}</v></c>")
    sheet = f'<worksheet xmlns="{ns}"><sheetData><row>{"".join(cells)}</row></sheetData></worksheet>'
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("[Content_Types].xml", "<Types/>")
        z.writestr("xl/sharedStrings.xml", f'<sst xmlns="{ns}">{sst}</sst>')
        z.writestr("xl/worksheets/sheet1.xml", sheet)
    return buf.getvalue()


def make_pdf(texts, compress=False):
    content = b"BT /F1 12 Tf " + b" ".join(
        b"(" + t.encode() + b") Tj 0 -14 Td" for t in texts
    ) + b" ET"
    if compress:
        stream = zlib.compress(content)
    else:
        stream = content
    return (
        b"%PDF-1.4\n1 0 obj\n<< /Length " + str(len(stream)).encode() + b" >>\n"
        b"stream\n" + stream + b"\nendstream\nendobj\n%%EOF"
    )


def test_docx_extraction():
    data = make_docx(["Hello word processor", "Second paragraph"])
    out = extract_text("report.docx", "", data)
    assert out == "Hello word processor\nSecond paragraph"


def test_pptx_extraction():
    data = make_pptx([["Title slide", "subtitle"], ["Second slide"]])
    out = extract_text("deck.pptx", "", data)
    assert "Title slide" in out and "Second slide" in out


def test_xlsx_extraction():
    data = make_xlsx([(0, "s"), (1, "s"), ("42.5", "n")], ["alpha cell", "beta"])
    out = extract_text("sheet.xlsx", "", data)
    assert "alpha cell" in out and "beta" in out and "42.5" in out


def test_rtf_extraction():
    rtf = (
        rb"{\rtf1\ansi{\fonttbl{\f0 Helvetica;}}"
        rb"\f0\fs24 Hello \b bold\b0  world.\par Second line \'e9 accent}"
    )
    out = extract_text("doc.rtf", "application/rtf", rtf)
    assert "Hello bold world." in out
    assert "Second line" in out and "é" in out
    assert "Helvetica" not in out  # font table skipped


def test_pdf_extraction_plain_and_flate():
    for compress in (False, True):
        data = make_pdf(["Searchable pdf text", "line two"], compress=compress)
        out = extract_text("doc.pdf", "application/pdf", data)
        assert out is not None and "Searchable pdf text" in out, compress
        assert "line two" in out


def test_pdf_tj_array_and_escapes():
    content = rb"BT [(Par\164ial) -250 (arr\(ay\))] TJ ET"
    data = (
        b"%PDF-1.4\nstream\n" + content + b"\nendstream\n%%EOF"
    )
    out = extract_text("x.pdf", "application/pdf", data)
    assert "Partial" in out and "arr(ay)" in out


def test_pdf_cid_garbage_rejected():
    # hex-show of glyph ids (not character codes) -> unprintable soup
    body = b"BT <0001000200030004000500060007> Tj ET"
    data = b"%PDF-1.4\nstream\n" + body + b"\nendstream\n%%EOF"
    assert extract_text("cid.pdf", "application/pdf", data) is None


def test_sniff_binary_types():
    assert sniff_content_type("a.docx", "") .endswith("wordprocessingml.document")
    assert sniff_content_type("a.pdf", "application/octet-stream") == "application/pdf"


def test_upload_docx_becomes_searchable(tmp_path):
    from nucliadb_tpu_torch.common.kb import KnowledgeBoxManager
    from nucliadb_tpu_torch.ingest.processor import Processor
    from nucliadb_tpu_torch.maindb import Driver
    from nucliadb_tpu_torch.models.api import (
        CreateResourcePayload,
        FindRequest,
        KnowledgeBoxConfig,
        SearchFeature,
        TextFieldPayload,
        UpdateResourcePayload,
    )
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.search import SearchService

    driver = Driver(str(tmp_path / "db.sqlite"))
    node = EmbeddedNode(device="cpu", data_dir=str(tmp_path / "node"))
    kbs = KnowledgeBoxManager(driver, node)
    kbid = kbs.create(KnowledgeBoxConfig(slug="docx-kb"))
    processor = Processor(driver, node, kbs)
    rid, _ = processor.create_resource(kbid, CreateResourcePayload(title="d"))

    text = extract_text("r.docx", "", make_docx(["findable docx content"]))
    processor.update_resource(
        kbid, rid,
        UpdateResourcePayload(texts={"doc": TextFieldPayload(body=text, format="EXTRACTED")}),
    )
    node.wait_for_sync()
    search = SearchService(node, kbs, processor)
    out = search.find(kbid, FindRequest(query="findable docx", features=[SearchFeature.KEYWORD]))
    assert rid in out.resources


def test_rtf_unicode_fallback_skipped():
    """Regression: \\uN emitted the Unicode scalar AND the \\ucN ANSI
    fallback that follows it ('?' after every non-Latin char)."""
    from nucliadb_tpu_torch.ingest.extract_binary import rtf_text

    rtf = rb"{\rtf1\ansi\uc1 day \u26085? and \u-3913\'3f end}"
    out = rtf_text(rtf)
    assert chr(26085) in out  # U+65E5
    assert chr((-3913) & 0xFFFF) in out  # signed 16-bit wrap
    assert "?" not in out  # fallback chars not duplicated into the text
    assert "day" in out and "and" in out and "end" in out

    # \uc0 declares no fallback chars: nothing may be skipped
    out0 = rtf_text(rb"{\rtf1\ansi\uc0\u26085 x}")
    assert chr(26085) in out0 and "x" in out0

    # \uc is GROUP-scoped: a \uc2 inside a closed group must not keep
    # eating real text after later \uN outside it
    outg = rtf_text(rb"{\rtf1\ansi{\uc2\u26085?? inner}\u26085?abc}")
    assert "inner" in outg and "abc" in outg and "?" not in outg

    # CR/LF line wraps between \uN and its fallback are not characters
    outw = rtf_text(b"{\\rtf1\\ansi\\uc1 x \\u26085\r\n? y}")
    assert chr(26085) in outw and "?" not in outw and "y" in outw
