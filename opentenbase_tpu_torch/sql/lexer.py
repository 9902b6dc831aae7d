"""SQL lexer.

Reference analog: the flex scanner src/backend/parser/scan.l.  Hand-rolled
here (no bison/flex): a small tokenizer producing (kind, value, pos) tuples.
"""

from __future__ import annotations

import dataclasses
import enum


class SqlSyntaxError(Exception):
    def __init__(self, msg: str, sql: str = "", pos: int = -1):
        if pos >= 0:
            line = sql.count("\n", 0, pos) + 1
            col = pos - (sql.rfind("\n", 0, pos) + 1) + 1
            msg = f"{msg} at line {line}, column {col}"
        super().__init__(msg)


class Tok(enum.Enum):
    IDENT = "ident"
    NUM = "num"
    STR = "str"
    PARAM = "param"   # $1, $2 ... (extended protocol binds)
    OP = "op"
    EOF = "eof"


KEYWORDS = frozenset("""
select from where group by having order asc desc limit offset distinct all
as and or not in is null like between exists any some case when then else end
cast extract interval substring date true false inner left right full outer
join on cross union except intersect values insert into update set delete
create table drop sequence index primary key unique if replicated
distribute shard hash modulo roundrobin replication to with copy delimiter
csv header begin commit rollback abort transaction work explain analyze
analyse verbose vacuum show node group barrier execute direct prepare
deallocate start for using nulls first last natural count sum avg min max
coalesce nullif greatest least exclude checkpoint cluster pause unpause
move year month day second minute hour nowait
check references foreign truncate savepoint release merge matched
""".split())

# fully reserved: cannot be used as table/column/alias identifiers
RESERVED = frozenset("""
select from where group by having order limit offset distinct as and or not
in is null like between exists case when then else end cast join on inner
left right full outer cross union except intersect values insert into update
set delete create drop table with asc desc
""".split())

_THREE_CHAR_OPS = {"<->", "<=>", "<#>"}   # pgvector distance operators
_TWO_CHAR_OPS = {"<=", ">=", "<>", "!=", "||", "::"}


@dataclasses.dataclass
class Token:
    kind: Tok
    value: str       # keywords and idents lowercased; operators verbatim
    pos: int
    is_keyword: bool = False


def lex(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SqlSyntaxError("unterminated comment", sql, i)
            i = j + 2
            continue
        if c == "'":
            # SQL string literal with '' escaping
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlSyntaxError("unterminated string", sql, i)
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            toks.append(Token(Tok.STR, "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlSyntaxError("unterminated quoted identifier", sql, i)
            toks.append(Token(Tok.IDENT, sql[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    if j + 1 < n and (sql[j + 1].isdigit()
                                      or sql[j + 1] in "+-"):
                        seen_exp = True
                        j += 2
                    else:
                        break
                else:
                    break
            toks.append(Token(Tok.NUM, sql[i:j], i))
            i = j
            continue
        if c == "$" and i + 1 < n and sql[i + 1].isdigit():
            j = i + 1
            while j < n and sql[j].isdigit():
                j += 1
            toks.append(Token(Tok.PARAM, sql[i + 1:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j].lower()
            toks.append(Token(Tok.IDENT, word, i, is_keyword=word in KEYWORDS))
            i = j
            continue
        three = sql[i:i + 3]
        if three in _THREE_CHAR_OPS:
            toks.append(Token(Tok.OP, three, i))
            i += 3
            continue
        two = sql[i:i + 2]
        if two in _TWO_CHAR_OPS:
            toks.append(Token(Tok.OP, two, i))
            i += 2
            continue
        if c in "+-*/%=<>(),.;[]":
            toks.append(Token(Tok.OP, c, i))
            i += 1
            continue
        raise SqlSyntaxError(f"unexpected character {c!r}", sql, i)
    toks.append(Token(Tok.EOF, "", n))
    return toks
