"""SQL tokenizer (reference: pkg/sql/parsers mysql_lexer.go — redesigned)."""

from __future__ import annotations

import dataclasses
from typing import List

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "between", "like", "is",
    "null", "true", "false", "case", "when", "then", "else", "end", "cast",
    "distinct", "asc", "desc", "join", "inner", "left", "right", "cross",
    "outer", "on", "create", "drop", "table", "index", "insert", "into",
    "values", "delete", "update", "set", "show", "tables", "explain",
    "analyze", "date", "interval", "day", "month", "year", "primary",
    "key", "if", "exists", "using", "begin", "commit", "rollback", "with",
    "union", "all", "default", "lists", "op_type", "count", "sum",
    "snapshot", "snapshots", "restore", "of", "timestamp", "avg",
    "auto_increment", "over", "partition",
    "min", "max", "extract",
}

OPERATORS = ["<=", ">=", "<>", "!=", "||", "=", "<", ">", "+", "-", "*", "/",
             "%", "(", ")", ",", ".", ";", "?"]


@dataclasses.dataclass
class Token:
    kind: str     # 'kw' | 'ident' | 'int' | 'float' | 'str' | 'op' | 'eof'
    value: str
    pos: int


class LexError(ValueError):
    pass


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i)
            if j < 0:
                raise LexError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n and (sql[j].isdigit() or sql[j] in ".eE+-"):
                if sql[j] == ".":
                    if seen_dot:
                        break
                    seen_dot = True
                elif sql[j] in "eE":
                    if seen_exp:
                        break
                    seen_exp = True
                elif sql[j] in "+-" and sql[j - 1] not in "eE":
                    break
                j += 1
            text = sql[i:j]
            out.append(Token("float" if ("." in text or "e" in text.lower())
                             else "int", text, i))
            i = j
            continue
        if c == "@" and sql.startswith("@@", i):
            # system variable reference: @@name / @@session.name
            j = i + 2
            while j < n and (sql[j].isalnum() or sql[j] in "_."):
                j += 1
            out.append(Token("sysvar", sql[i + 2:j].lower(), i))
            i = j
            continue
        if c == "$" and sql.startswith("$$", i):
            # dollar-quoted body (CREATE FUNCTION ... AS $$ ... $$):
            # verbatim text, no escape processing — Python bodies are
            # full of quotes and backslashes
            j = sql.find("$$", i + 2)
            if j < 0:
                raise LexError(f"unterminated $$ body at {i}")
            out.append(Token("str", sql[i + 2:j], i))
            i = j + 2
            continue
        if c == "'" or c == '"':
            quote = c
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == quote:
                    if j + 1 < n and sql[j + 1] == quote:  # escaped ''
                        buf.append(quote)
                        j += 2
                        continue
                    break
                if sql[j] == "\\" and j + 1 < n:
                    esc = sql[j + 1]
                    buf.append({"n": "\n", "t": "\t", "\\": "\\",
                                "'": "'", '"': '"'}.get(esc, esc))
                    j += 2
                    continue
                buf.append(sql[j])
                j += 1
            if j >= n:
                raise LexError(f"unterminated string at {i}")
            out.append(Token("str", "".join(buf), i))
            i = j + 1
            continue
        if c == "`":
            j = sql.find("`", i + 1)
            if j < 0:
                raise LexError(f"unterminated identifier at {i}")
            out.append(Token("ident", sql[i + 1:j], i))
            i = j + 1
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            low = word.lower()
            out.append(Token("kw" if low in KEYWORDS else "ident",
                             low if low in KEYWORDS else word, i))
            i = j
            continue
        for op in OPERATORS:
            if sql.startswith(op, i):
                out.append(Token("op", op, i))
                i += len(op)
                break
        else:
            raise LexError(f"unexpected character {c!r} at {i}")
    out.append(Token("eof", "", n))
    return out
