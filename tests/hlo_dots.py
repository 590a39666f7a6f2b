"""The FLOPs of the products in a compiled XLA program: every ``dot`` of
its HLO text (``compiled.as_text()``), 2 x the output's elements x the
contracted size, each counted as many times as the program runs it: a
``while`` body (a ``lax.scan`` over layers, chunks or time steps) times
its ``known_trip_count``, nested loops multiplied.  This is what
``torch.utils.flop_counter.FlopCounterMode`` counts of an eager step,
which runs every iteration; XLA's ``cost_analysis()`` adds elementwise
work and counts a loop body once.  Imports nothing: the tests run it in
the reference's subprocess."""

import re

_DEF = re.compile(r"\s*(?:ROOT )?%?([\w.\-]+) = \w+\[([\d,]*)\]")
_DOT = re.compile(r"\s*(?:ROOT )?%?[\w.\-]+ = \w+\[([\d,]*)\][^ ]* "
                  r"dot\(%?([\w.\-]+), %?[\w.\-]+\)"
                  r".*lhs_contracting_dims=\{([\d,]*)\}")
_HEAD = re.compile(r"^(ENTRY )?%?([\w.\-]+) .*\{\s*$")
_CALLS = re.compile(r"(?:condition|body|calls|to_apply|true_computation|"
                    r"false_computation)=%?([\w.\-]+)")
_BRANCHES = re.compile(r"branch_computations=\{([^}]*)\}")
_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')


def _dims(text):
    return [int(x) for x in text.split(",") if x]


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def dot_flops(hlo: str) -> int:
    comps, cur, entry = {}, None, None
    for line in hlo.splitlines():
        m = _HEAD.match(line)
        if m:
            cur = m.group(2)
            comps[cur] = []
            if m.group(1):
                entry = cur
        elif cur is not None:
            comps[cur].append(line)
    shapes = {}
    for body in comps.values():
        for line in body:
            m = _DEF.match(line)
            if m:
                shapes[m.group(1)] = _dims(m.group(2))
    # how often each computation runs: the text defines a computation
    # before its callers, so callers first is the reverse order
    runs = dict.fromkeys(comps, 0)
    runs[entry] = 1
    for name in reversed(list(comps)):
        for line in comps[name]:
            called = _CALLS.findall(line)
            b = _BRANCHES.search(line)
            if b:
                called += [x.strip().lstrip("%") for x in b.group(1).split(",")]
            times = 1
            if " while(" in line:
                trip = _TRIP.search(line)
                assert trip, "a while loop without a known trip count"
                times = int(trip.group(1))
            for callee in called:
                runs[callee] += runs[name] * times
    total = 0
    for name, body in comps.items():
        for line in body:
            if " dot(" not in line:
                continue
            m = _DOT.match(line)
            assert m, line
            lhs = shapes[m.group(2)]
            total += runs[name] * 2 * _prod(_dims(m.group(1))) * _prod(
                lhs[i] for i in _dims(m.group(3)))
    return total
