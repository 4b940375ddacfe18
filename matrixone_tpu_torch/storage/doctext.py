"""Document text extraction for datalinks: the port's copy of
`matrixone_tpu/storage/doctext.py` (stdlib only).

Reference: pkg/datalink's pdf/docx readers feeding AI pipelines
(load_file() over document types). No document library is used:
both formats are decoded from their public specs with the stdlib:

  * .docx — a zip containing word/document.xml (OOXML): paragraphs are
    <w:p>, text runs are <w:t>; tags stripped via ElementTree.
  * .pdf  — objects scanned for content streams; FlateDecode streams
    are inflated and the text-showing operators (Tj, TJ, ') yield the
    strings, with the standard escape sequences unescaped. This covers
    the simple text-first PDFs the reference's reader targets (embedded
    CMap/encoding exotica degrade to best-effort).
"""

from __future__ import annotations

import io
import re
import zipfile
import zlib
from typing import List

_W_NS = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"


def docx_to_text(blob: bytes) -> str:
    import xml.etree.ElementTree as ET
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        xml = z.read("word/document.xml")
    root = ET.fromstring(xml)
    paras: List[str] = []
    for p in root.iter(f"{_W_NS}p"):
        runs = [t.text or "" for t in p.iter(f"{_W_NS}t")]
        if runs:
            paras.append("".join(runs))
    return "\n".join(paras)


_PDF_STREAM = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.S)
#: text-showing operators scanned in ONE pass so document order holds
#: even when a stream mixes Tj/' with TJ arrays (kerned runs)
_PDF_SHOW = re.compile(
    rb"(\((?:\\.|[^()\\])*\)\s*(?:Tj|'))"
    rb"|(\[(?:[^\[\]\\]|\\.)*\]\s*TJ)")
_PDF_STR = re.compile(rb"\((?:\\.|[^()\\])*\)")


def _unescape_pdf(s: bytes) -> str:
    out = []
    i = 0
    body = s[1:-1]                      # strip ( )
    while i < len(body):
        c = body[i]
        if c == 0x5C and i + 1 < len(body):      # backslash
            n = body[i + 1]
            mapped = {0x6E: "\n", 0x72: "\r", 0x74: "\t",
                      0x28: "(", 0x29: ")", 0x5C: "\\"}.get(n)
            if mapped is not None:
                out.append(mapped)
                i += 2
                continue
            if 0x30 <= n <= 0x37:                # octal escape
                oct_digits = bytes(body[i + 1:i + 4])
                k = 1
                while k < 3 and k < len(oct_digits) and \
                        0x30 <= oct_digits[k] <= 0x37:
                    k += 1
                out.append(chr(int(oct_digits[:k], 8)))
                i += 1 + k
                continue
            i += 1
            continue
        out.append(chr(c))
        i += 1
    return "".join(out)


def pdf_to_text(blob: bytes) -> str:
    texts: List[str] = []
    for m in _PDF_STREAM.finditer(blob):
        data = m.group(1)
        try:
            data = zlib.decompress(data)
        except zlib.error:
            pass                       # uncompressed content stream
        line: List[str] = []
        for m2 in _PDF_SHOW.finditer(data):
            for s in _PDF_STR.finditer(m2.group(0)):
                line.append(_unescape_pdf(s.group(0)))
        if line:
            texts.append("".join(line))
    return "\n".join(texts)


def extract_text(url: str, blob: bytes) -> str:
    """Dispatch by extension; unknown types decode as UTF-8 text."""
    low = url.lower()
    if low.endswith(".docx"):
        return docx_to_text(blob)
    if low.endswith(".pdf"):
        return pdf_to_text(blob)
    return blob.decode("utf-8", errors="replace")
