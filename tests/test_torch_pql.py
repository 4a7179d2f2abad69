"""The port's PQL parser (`pilosa_tpu_torch.pql`): the golden cases of
`tests/test_pql.py` for every call form, conditions, conditionals,
quoting and errors, against the same literals.
"""

import pytest

from pilosa_tpu_torch.pql import (
    BETWEEN,
    Call,
    Condition,
    EQ,
    GT,
    GTE,
    LT,
    LTE,
    NEQ,
    ParseError,
    parse,
)


def one(src):
    q = parse(src)
    assert len(q.calls) == 1, q
    return q.calls[0]


def test_empty():
    assert parse("").calls == []
    assert parse("  \n\t ").calls == []


def test_row():
    c = one("Row(stargazer=10)")
    assert c == Call("Row", {"stargazer": 10})


def test_row_string_key():
    assert one('Row(f="key1")') == Call("Row", {"f": "key1"})
    assert one("Row(f='key1')") == Call("Row", {"f": "key1"})
    assert one("Row(f=word-with_chars:x)") == Call(
        "Row", {"f": "word-with_chars:x"})


def test_multiple_calls():
    q = parse("Row(a=1) Row(b=2)\nCount(Row(c=3))")
    assert [c.name for c in q.calls] == ["Row", "Row", "Count"]


def test_nested_children():
    c = one("Intersect(Row(a=1), Row(b=2))")
    assert c.name == "Intersect"
    assert c.children == [Call("Row", {"a": 1}), Call("Row", {"b": 2})]


def test_children_plus_args():
    c = one("TopN(f, Row(other=7), n=4)")
    assert c.args["_field"] == "f"
    assert c.args["n"] == 4
    assert c.children == [Call("Row", {"other": 7})]


def test_set():
    c = one("Set(1, f=10)")
    assert c == Call("Set", {"_col": 1, "f": 10})


def test_set_with_timestamp():
    c = one("Set(9, f=10, 2019-05-01T10:32)")
    assert c.args["_timestamp"] == "2019-05-01T10:32"
    assert c.args["_col"] == 9 and c.args["f"] == 10


def test_set_string_col():
    c = one("Set('col-key', f='row-key')")
    assert c.args["_col"] == "col-key"
    assert c.args["f"] == "row-key"


def test_set_bool_value():
    assert one("Set(1, b=true)").args["b"] is True
    assert one("Set(1, b=false)").args["b"] is False


def test_clear_and_clearrow():
    assert one("Clear(3, f=1)") == Call("Clear", {"_col": 3, "f": 1})
    assert one("ClearRow(f=5)") == Call("ClearRow", {"f": 5})


def test_store():
    c = one("Store(Row(f=10), g=44)")
    assert c.name == "Store"
    assert c.children == [Call("Row", {"f": 10})]
    assert c.args == {"g": 44}


def test_setrowattrs():
    c = one('SetRowAttrs(f, 10, foo="bar", baz=123, act=true)')
    assert c.args == {"_field": "f", "_row": 10, "foo": "bar",
                      "baz": 123, "act": True}


def test_setcolumnattrs():
    c = one('SetColumnAttrs(7, x=null, y=-2.5)')
    assert c.args["_col"] == 7
    assert c.args["x"] is None
    assert c.args["y"] == -2.5


def test_topn_bare():
    assert one("TopN(f)") == Call("TopN", {"_field": "f"})
    assert one("TopN(f, n=25)") == Call("TopN", {"_field": "f", "n": 25})


def test_rows():
    c = one("Rows(f, previous=10, limit=100, column=3)")
    assert c.args == {"_field": "f", "previous": 10, "limit": 100, "column": 3}


def test_groupby_with_filter():
    c = one("GroupBy(Rows(a), Rows(b), filter=Row(c=1), limit=10)")
    assert [ch.name for ch in c.children] == ["Rows", "Rows"]
    assert c.args["filter"] == Call("Row", {"c": 1})
    assert c.args["limit"] == 10


def test_conditions():
    for src, op in [("Row(n > 5)", GT), ("Row(n >= 5)", GTE),
                    ("Row(n < 5)", LT), ("Row(n <= 5)", LTE),
                    ("Row(n == 5)", EQ), ("Row(n != 5)", NEQ)]:
        c = one(src)
        assert c.args["n"] == Condition(op, 5), src


def test_condition_negative():
    assert one("Row(n>-3)").args["n"] == Condition(GT, -3)


def test_between_conditional():
    assert one("Row(4 < n <= 9)").args["n"] == Condition(BETWEEN, [5, 9])
    assert one("Row(4 <= n <= 9)").args["n"] == Condition(BETWEEN, [4, 9])
    assert one("Row(-10 < n < 10)").args["n"] == Condition(BETWEEN, [-9, 9])


def test_between_cond_operator():
    c = one("Row(n >< [4, 9])")
    assert c.args["n"] == Condition(BETWEEN, [4, 9])


def test_range_deprecated_time_form():
    c = one("Range(f=10, from=2017-01-01T00:00, to=2018-01-01T00:00)")
    assert c.name == "Range"
    assert c.args == {"f": 10, "from": "2017-01-01T00:00",
                      "to": "2018-01-01T00:00"}


def test_range_generic_form():
    c = one("Range(n > 5)")
    assert c.args["n"] == Condition(GT, 5)


def test_row_time_range_args():
    c = one("Row(f=1, from='2017-01-01T00:00', to='2018-01-01T00:00')")
    assert c.args["from"] == "2017-01-01T00:00"


def test_float_and_int_values():
    c = one("Call(a=1, b=-2, c=3.5, d=-4.25, e=0)")
    assert c.args == {"a": 1, "b": -2, "c": 3.5, "d": -4.25, "e": 0}


def test_list_value():
    c = one("Call(ids=[1, 2, 3], words=[a, b])")
    assert c.args["ids"] == [1, 2, 3]
    assert c.args["words"] == ["a", "b"]


def test_quoted_escapes():
    assert one(r'Row(f="a\"b")').args["f"] == 'a"b'
    assert one(r"Row(f='a\'b')").args["f"] == "a'b"


def test_trailing_comma_generic():
    c = one("Options(Row(f=1), shards=[0, 2],)")
    assert c.name == "Options"


def test_not_and_count():
    c = one("Count(Not(Row(f=1)))")
    assert c.children[0].name == "Not"
    assert c.children[0].children[0] == Call("Row", {"f": 1})


def test_errors():
    for bad in ["Row(", "Row)", "Set(1 f=1)", "Row(f==)", "Row(f=1",
                "123", "Row(f=1) garbage", "Row(f=1,,f=2)",
                "Row(f=1, f=2)"]:
        with pytest.raises(ParseError):
            parse(bad)


def test_duplicate_arg_rejected():
    with pytest.raises(ParseError):
        parse("Row(a=1, a=2)")


def test_timestamp_value_kept_as_string():
    c = one("Row(f=1, from=2017-01-01T00:00)")
    assert isinstance(c.args["from"], str)


def test_writes_classification():
    q = parse("Set(1, f=1) Row(f=1) Clear(1, f=1)")
    assert [c.name for c in q.write_calls()] == ["Set", "Clear"]


# ------------------------------------------- the reference's parser, alike

REFERENCE_SOURCES = [
    "Row(stargazer=10)", 'Row(f="key1")', "Row(f=word-with_chars:x)",
    "Row(a=1) Row(b=2)\nCount(Row(c=3))", "TopN(f, Row(other=7), n=4)",
    "Set(9, f=10, 2019-05-01T10:32)", "Set('col-key', f='row-key')",
    "Store(Row(f=10), g=44)",
    'SetRowAttrs(f, 10, foo="bar", baz=123, act=true)',
    "SetColumnAttrs(7, x=null, y=-2.5)",
    "Rows(f, previous=10, limit=100, column=3)",
    "GroupBy(Rows(a), Rows(b), filter=Row(c=1), limit=10)",
    "Row(n>-3)", "Row(4 < n <= 9)", "Row(-10 < n < 10)", "Row(n >< [4, 9])",
    "Range(f=10, from=2017-01-01T00:00, to=2018-01-01T00:00)",
    "Call(a=1, b=-2, c=3.5, d=-4.25, e=0)",
    "Call(ids=[1, 2, 3], words=[a, b])", r'Row(f="a\"b")',
    "Options(Row(f=1), shards=[0, 2],)", "Count(Not(Row(f=1)))",
]


def _tree(node):
    """A package-neutral form of a parsed call tree."""
    if hasattr(node, "children") and hasattr(node, "args"):
        return (node.name, {k: _tree(v) for k, v in node.args.items()},
                [_tree(c) for c in node.children])
    if hasattr(node, "op") and hasattr(node, "value"):
        return ("cond", node.op, _tree(node.value))
    if isinstance(node, list):
        return [_tree(v) for v in node]
    return node


@pytest.mark.parametrize("src", REFERENCE_SOURCES)
def test_parses_like_reference(src):
    """The port's parser and writer give the TPU package's call tree and
    PQL text for each source."""
    from pilosa_tpu.pql import parse as ref_parse
    from pilosa_tpu.pql.writer import query_to_pql as ref_to_pql
    from pilosa_tpu_torch.pql import query_to_pql

    got, want = parse(src), ref_parse(src)
    assert [_tree(c) for c in got.calls] == [_tree(c) for c in want.calls]
    assert query_to_pql(got) == ref_to_pql(want)
