"""The string functions' semantics, one dictionary entry at a time.

The port of the host half of `matrixone_tpu/vm/exprs.py`'s string
functions: `_STRING_FUNCS` and `_apply_string_func` (MySQL behaviour in
plain Python).  vm/exprs.py runs them over a column's dictionary — work
per DISTINCT value, never per row — and gathers the result on the
device by code.
"""

from __future__ import annotations


class EvalError(ValueError):
    pass


_STRING_FUNCS = {"upper", "lower", "length", "reverse", "trim", "ltrim",
                 "rtrim", "concat", "substring", "replace", "starts_with",
                 "ends_with",
                 # long tail: dictionary-level
                 # Python semantics, device gather on codes — O(uniques)
                 # host work per batch, never O(rows)
                 "lpad", "rpad", "repeat", "instr", "locate", "ascii",
                 "bit_length", "hex", "unhex", "md5", "sha1", "sha2",
                 "crc32", "to_base64", "from_base64", "substring_index",
                 "field", "find_in_set", "strcmp", "space", "soundex",
                 "quote", "bin", "oct", "conv",
                 "regexp_like", "regexp_instr", "regexp_substr",
                 "regexp_replace",
                 "json_extract", "json_unquote", "json_valid",
                 "json_length", "json_type", "json_keys",
                 # index-less MATCH AGAINST fallback (WHERE truthiness /
                 # un-indexed scans): tf of query terms per dictionary
                 # entry — the BM25-ranked path is the fulltext INDEX
                 # rewrite (vm/fulltext_scan.py)
                 "match_against",
                 # geo over WKT strings (reference: pkg/geo) — planar
                 # semantics evaluated on the dictionary (geo.py)
                 "st_geomfromtext", "st_astext", "st_x", "st_y",
                 "st_distance", "st_within", "st_contains", "st_area",
                 "st_geohash",
                 # long tail (function_id.go families)
                 "left", "right", "ord", "insert_str", "elt",
                 "concat_ws", "split_part", "octet_length", "inet_aton",
                 "str_to_date", "time_to_sec",
                 # long tail: net/json/time-string families
                 "is_ipv4", "is_ipv6", "inet6_aton", "inet6_ntoa",
                 "json_quote", "json_contains",
                 "timediff", "addtime", "subtime", "time_format",
                 # LLM: one endpoint call per DISTINCT value
                 "llm_chat"}


#: marks the COLUMN's position in a string call's literal list — distinct
#: from None, which is a genuine NULL literal argument
_COLPOS = object()


def _json_parse(s):
    import json as _json
    try:
        return _json.loads(s)
    except (ValueError, TypeError):
        return _JSON_BAD


_JSON_BAD = object()


def _json_path(doc, path: str):
    """$.a.b[0] subset of MySQL JSON paths; returns _JSON_BAD on miss
    AND on any path syntax outside the subset (never a silent partial
    parse that extracts from the wrong place)."""
    import re as _re
    if not _re.fullmatch(r"\$(?:\.[A-Za-z_][A-Za-z_0-9]*|\[\d+\])*",
                         path):
        return _JSON_BAD
    cur = doc
    for m in _re.finditer(r"\.([A-Za-z_][A-Za-z_0-9]*)|\[(\d+)\]",
                          path[1:]):
        key, idx = m.group(1), m.group(2)
        if key is not None:
            if not isinstance(cur, dict) or key not in cur:
                return _JSON_BAD
            cur = cur[key]
        else:
            i = int(idx)
            if not isinstance(cur, list) or i >= len(cur):
                return _JSON_BAD
            cur = cur[i]
    return cur


def _parse_time_str(s: str):
    """'[-]H+:MM:SS' (MySQL TIME text, hours may exceed 23) -> signed
    seconds, or None on malformed input."""
    import re as _re
    m = _re.fullmatch(r"(-?)(\d{1,3}):([0-5]?\d):([0-5]?\d)(?:\.\d+)?",
                      s.strip())
    if m is None:
        return None
    sec = int(m.group(2)) * 3600 + int(m.group(3)) * 60 + int(m.group(4))
    return -sec if m.group(1) else sec


def _fmt_time(sec: int) -> str:
    sign = "-" if sec < 0 else ""
    sec = abs(sec)
    return f"{sign}{sec // 3600:02d}:{sec % 3600 // 60:02d}:{sec % 60:02d}"


def _is_ipv6_text(s: str) -> bool:
    import ipaddress
    try:
        return isinstance(ipaddress.ip_address(s.strip()),
                          ipaddress.IPv6Address)
    except ValueError:
        return False


def _soundex(s: str) -> str:
    codes = {**dict.fromkeys("BFPV", "1"), **dict.fromkeys("CGJKQSXZ", "2"),
             **dict.fromkeys("DT", "3"), "L": "4",
             **dict.fromkeys("MN", "5"), "R": "6"}
    s = "".join(c for c in s.upper() if c.isalpha())
    if not s:
        return ""
    out = s[0]
    prev = codes.get(s[0], "")
    for c in s[1:]:
        code = codes.get(c, "")
        if code and code != prev:
            out += code
        if c not in "HW":
            prev = code
    return (out + "000")[:4]


def _apply_string_func(op, s, lits):
    """Python-level semantics per dictionary entry (MySQL behavior).
    Returns None for SQL NULL results (invalid input etc.)."""
    import base64
    import hashlib
    import re as _re
    import zlib

    def args():
        return [x for x in lits if x is not _COLPOS]

    def at(i, default=None):
        """Positional arg: the dictionary entry if the column sits at
        position i, else the literal there."""
        if i >= len(lits):
            return default
        return s if lits[i] is _COLPOS else lits[i]

    # MySQL: a NULL argument yields NULL — except functions with
    # explicit NULL semantics (concat_ws skips NULLs; elt/coalesce
    # handle them positionally)
    if op not in ("concat_ws", "elt") and any(x is None for x in lits):
        return None

    if op == "is_ipv4":
        parts = at(0, "").split(".")
        return len(parts) == 4 and all(
            p.isdigit() and len(p) <= 3 and int(p) <= 255 for p in parts)
    if op == "is_ipv6":
        return _is_ipv6_text(at(0, ""))
    if op == "inet6_aton":
        # MySQL returns VARBINARY(16); surfaced here as its hex text
        # (the engine has no binary type — hex() of the reference value)
        import ipaddress
        try:
            return ipaddress.ip_address(at(0, "").strip()).packed.hex()
        except ValueError:
            return None
    if op == "inet6_ntoa":
        import ipaddress
        try:
            raw = bytes.fromhex(at(0, ""))
            if len(raw) not in (4, 16):
                return None
            return str(ipaddress.ip_address(raw))
        except ValueError:
            return None
    if op == "json_quote":
        import json as _json
        return _json.dumps(str(at(0, "")))
    if op == "json_contains":
        import json as _json
        doc = _json_parse(at(0, ""))
        cand = _json_parse(at(1, ""))
        if doc is _JSON_BAD or cand is _JSON_BAD:
            return None

        def contains(d, c):
            # MySQL: a candidate ARRAY is contained in a target array
            # iff EVERY candidate element is contained in SOME element
            # of the target; a non-array candidate iff some target
            # element contains it
            if isinstance(d, list):
                if isinstance(c, list):
                    return all(any(contains(x, y) for x in d) for y in c)
                return any(contains(x, c) for x in d)
            if isinstance(d, dict) and isinstance(c, dict):
                return all(k in d and contains(d[k], v)
                           for k, v in c.items())
            if isinstance(d, bool) != isinstance(c, bool):
                return False        # MySQL: true != 1 in JSON
            return d == c
        return bool(contains(doc, cand))
    if op == "timediff":
        a, b = _parse_time_str(at(0, "")), _parse_time_str(at(1, ""))
        if a is None or b is None:
            return None
        return _fmt_time(a - b)
    if op in ("addtime", "subtime"):
        a, b = _parse_time_str(at(0, "")), _parse_time_str(at(1, ""))
        if a is None or b is None:
            return None
        return _fmt_time(a + b if op == "addtime" else a - b)
    if op == "time_format":
        sec = _parse_time_str(at(0, ""))
        fmt = at(1, "%H:%i:%s")
        if sec is None or fmt is None:
            return None
        sign = "-" if sec < 0 else ""
        sec = abs(sec)
        h, mi, ss = sec // 3600, sec % 3600 // 60, sec % 60
        out, i = [], 0
        while i < len(fmt):
            if fmt[i] == "%" and i + 1 < len(fmt):
                c = fmt[i + 1]
                i += 2
                if c == "H":
                    out.append(f"{sign}{h:02d}")
                elif c == "k":
                    out.append(f"{sign}{h}")
                elif c == "h" or c == "I":
                    out.append(f"{(h % 12) or 12:02d}")
                elif c == "i":
                    out.append(f"{mi:02d}")
                elif c == "s" or c == "S":
                    out.append(f"{ss:02d}")
                elif c == "p":
                    out.append("AM" if (h % 24) < 12 else "PM")
                elif c == "T":
                    out.append(f"{sign}{h:02d}:{mi:02d}:{ss:02d}")
                else:
                    out.append(c)
            else:
                out.append(fmt[i])
                i += 1
        return "".join(out)
    if op == "upper":
        return s.upper()
    if op == "lower":
        return s.lower()
    if op == "length":
        return len(s.encode())
    if op == "bit_length":
        return len(s.encode()) * 8
    if op == "ascii":
        return ord(s[0]) if s else 0
    if op == "reverse":
        return s[::-1]
    if op == "trim":
        return s.strip()
    if op == "ltrim":
        return s.lstrip()
    if op == "rtrim":
        return s.rstrip()
    if op == "concat":
        return "".join(s if x is _COLPOS else str(x) for x in lits)
    if op == "substring":
        a = args()
        start = int(a[0])
        start = start - 1 if start > 0 else len(s) + start
        if len(a) > 1:
            return s[start:start + int(a[1])]
        return s[start:]
    if op == "replace":
        a = args()
        return s.replace(str(a[0]), str(a[1]))
    if op == "starts_with":
        return s.startswith(str(args()[0]))
    if op == "ends_with":
        return s.endswith(str(args()[0]))
    if op == "lpad":
        a = args()
        n, pad = int(a[0]), str(a[1]) if len(a) > 1 else " "
        if n <= len(s):
            return s[:n]
        if not pad:
            return ""        # MySQL: cannot fill with an empty pad
        return (pad * n)[:n - len(s)] + s
    if op == "rpad":
        a = args()
        n, pad = int(a[0]), str(a[1]) if len(a) > 1 else " "
        if n <= len(s):
            return s[:n]
        if not pad:
            return ""
        return s + (pad * n)[:n - len(s)]
    if op == "repeat":
        n = int(args()[0])
        return s * max(n, 0)
    if op == "left":
        return s[:max(int(args()[0]), 0)]
    if op == "right":
        n = max(int(args()[0]), 0)
        return s[max(len(s) - n, 0):] if n else ""
    if op == "ord":
        # MySQL ORD: leftmost character's byte sequence as an int
        if not s:
            return 0
        out = 0
        for byte in s[0].encode():
            out = out * 256 + byte
        return out
    if op == "octet_length":
        return len(s.encode())
    if op == "insert_str":
        a = args()
        pos, ln, news = int(a[0]), int(a[1]), str(a[2])
        if pos < 1 or pos > len(s):
            return s
        return s[:pos - 1] + news + s[pos - 1 + max(ln, 0):]
    if op == "elt":
        idx = at(0)
        if idx is None:
            return None
        i = int(idx)
        options = [s if x is _COLPOS else
                   (None if x is None else str(x)) for x in lits[1:]]
        if i < 1 or i > len(options):
            return None
        return options[i - 1]
    if op == "concat_ws":
        sep = at(0)
        if sep is None:
            return None                   # NULL separator -> NULL
        parts = [s if x is _COLPOS else str(x)
                 for x in lits[1:] if x is not None]   # NULLs skipped
        return str(sep).join(parts)
    if op == "split_part":
        a = args()
        parts = s.split(str(a[0]))
        i = int(a[1])
        if i < 1 or i > len(parts):
            return None
        return parts[i - 1]
    if op == "inet_aton":
        try:
            p = s.split(".")
            if len(p) != 4 or any(not x.isdigit() or int(x) > 255
                                  for x in p):
                return None
            return (int(p[0]) << 24 | int(p[1]) << 16
                    | int(p[2]) << 8 | int(p[3]))
        except ValueError:
            return None
    if op == "str_to_date":
        import datetime as _dtm
        fmt = str(args()[0])
        pyfmt = (fmt.replace("%i", "%M").replace("%s", "%S")
                 .replace("%e", "%d").replace("%c", "%m"))
        try:
            d0 = _dtm.datetime.strptime(s, pyfmt).date()
            return (d0 - _dtm.date(1970, 1, 1)).days
        except ValueError:
            return None
    if op == "llm_chat":
        from matrixone_tpu_torch import llm as _llm
        from matrixone_tpu_torch.frontend.session import current_session
        sess = current_session()
        return _llm.chat(s, sess.variables if sess else None)
    if op == "time_to_sec":
        try:
            t = s.strip()
            neg = t.startswith("-")
            if neg:
                t = t[1:]
            hh, mm, ss = (t.split(":") + ["0", "0"])[:3]
            total = int(hh) * 3600 + int(mm) * 60 + int(float(ss))
            return -total if neg else total
        except ValueError:
            return None
    if op == "space":
        return " " * max(int(s), 0)
    if op == "instr":
        return str(at(0, "")).find(str(at(1, ""))) + 1
    if op == "locate":
        sub, subj = str(at(0, "")), str(at(1, ""))
        pos = int(at(2, 1))
        return subj.find(sub, max(pos - 1, 0)) + 1
    if op == "substring_index":
        a = args()
        delim, count = str(a[0]), int(a[1])
        if not delim:
            return ""
        parts = s.split(delim)
        if count > 0:
            return delim.join(parts[:count])
        if count < 0:
            return delim.join(parts[count:])
        return ""
    if op == "field":
        # the column may sit at ANY position: substitute the dictionary
        # entry at its placeholder before comparing
        full = [s if x is _COLPOS else str(x) for x in lits]
        try:
            return full[1:].index(full[0]) + 1
        except ValueError:
            return 0
    if op == "find_in_set":
        target, setstr = str(at(0, "")), str(at(1, ""))
        if not setstr:
            return 0
        items = setstr.split(",")
        try:
            return items.index(target) + 1
        except ValueError:
            return 0
    if op == "strcmp":
        a0, a1 = str(at(0, "")), str(at(1, ""))
        return -1 if a0 < a1 else (1 if a0 > a1 else 0)
    if op == "hex":
        return s.encode().hex().upper()
    if op == "unhex":
        try:
            return bytes.fromhex(s).decode("utf-8", errors="strict")
        except ValueError:
            return None
    if op == "md5":
        return hashlib.md5(s.encode()).hexdigest()
    if op == "sha1":
        return hashlib.sha1(s.encode()).hexdigest()
    if op == "sha2":
        bits = int(args()[0]) if args() else 256
        fn = {224: hashlib.sha224, 256: hashlib.sha256,
              384: hashlib.sha384, 512: hashlib.sha512,
              0: hashlib.sha256}.get(bits)
        return fn(s.encode()).hexdigest() if fn else None
    if op == "crc32":
        return zlib.crc32(s.encode())
    if op == "to_base64":
        return base64.b64encode(s.encode()).decode()
    if op == "from_base64":
        try:
            return base64.b64decode(s.encode(), validate=True).decode(
                "utf-8", errors="strict")
        except (ValueError, UnicodeDecodeError):
            return None
    if op == "soundex":
        return _soundex(s)
    if op == "quote":
        body = s.replace("\\", "\\\\").replace("'", "\\'")
        return f"'{body}'"
    if op in ("bin", "oct", "conv"):
        try:
            v = int(str(at(0, s)), 10 if op != "conv"
                    else int(args()[0]))
        except ValueError:
            return None
        if v < 0:
            # MySQL treats negatives as unsigned 64-bit two's complement
            v &= 0xFFFFFFFFFFFFFFFF
        if op == "bin":
            return format(v, "b")
        if op == "oct":
            return format(v, "o")
        to = int(args()[1])
        if not (2 <= to <= 36):
            return None
        digits = "0123456789abcdefghijklmnopqrstuvwxyz"
        out = ""
        while v:
            out = digits[v % to] + out
            v //= to
        return (out or "0").upper()
    if op == "regexp_like":
        return bool(_re.search(str(args()[0]), s))
    if op == "regexp_instr":
        m = _re.search(str(args()[0]), s)
        return (m.start() + 1) if m else 0
    if op == "regexp_substr":
        m = _re.search(str(args()[0]), s)
        return m.group(0) if m else None
    if op == "regexp_replace":
        a = args()
        return _re.sub(str(a[0]), str(a[1]), s)
    if op.startswith("st_"):
        from matrixone_tpu_torch import geo as G
        if op == "st_geohash":
            g = G.parse_wkt(s)
            if g is None or g.kind != "POINT":
                return None
            prec = int(args()[0]) if args() else 12
            return G.geohash(g.coords[0][0], g.coords[0][1],
                             max(1, min(prec, 12)))
        if op in ("st_distance", "st_within", "st_contains"):
            g1 = G.parse_wkt(str(at(0, "")))
            g2 = G.parse_wkt(str(at(1, "")))
            if g1 is None or g2 is None:
                return None
            if op == "st_distance":
                return G.distance(g1, g2)
            if op == "st_within":
                return G.contains(g2, g1)
            return G.contains(g1, g2)
        g = G.parse_wkt(s)
        if g is None:
            return None
        if op in ("st_geomfromtext", "st_astext"):
            return g.wkt()
        if op == "st_x":
            return g.coords[0][0] if g.kind == "POINT" else None
        if op == "st_y":
            return g.coords[0][1] if g.kind == "POINT" else None
        if op == "st_area":
            return G.area(g)
    if op == "match_against":
        from matrixone_tpu_torch.fulltext import tokenize as _ft_tokenize
        terms = set(_ft_tokenize(str(args()[0])))
        if not terms:
            return 0.0
        toks = _ft_tokenize(s)
        return float(sum(1 for t in toks if t in terms))
    if op.startswith("json_"):
        import json as _json
        doc = _json_parse(s)
        if op == "json_valid":
            return doc is not _JSON_BAD
        if doc is _JSON_BAD:
            return None
        if op == "json_extract":
            got = _json_path(doc, str(args()[0]))
            return None if got is _JSON_BAD else _json.dumps(
                got, separators=(", ", ": "), ensure_ascii=False)
        if op == "json_unquote":
            if isinstance(doc, str):
                return doc
            return s
        if op == "json_length":
            path = args()
            tgt = doc if not path else _json_path(doc, str(path[0]))
            if tgt is _JSON_BAD:
                return None
            return len(tgt) if isinstance(tgt, (list, dict)) else 1
        if op == "json_type":
            tgt = doc
            if args():
                tgt = _json_path(doc, str(args()[0]))
                if tgt is _JSON_BAD:
                    return None
            if isinstance(tgt, bool):
                return "BOOLEAN"
            if tgt is None:
                return "NULL"
            if isinstance(tgt, int):
                return "INTEGER"
            if isinstance(tgt, float):
                return "DOUBLE"
            if isinstance(tgt, str):
                return "STRING"
            return "ARRAY" if isinstance(tgt, list) else "OBJECT"
        if op == "json_keys":
            if not isinstance(doc, dict):
                return None
            return _json.dumps(list(doc.keys()), ensure_ascii=False)
    raise EvalError(op)
