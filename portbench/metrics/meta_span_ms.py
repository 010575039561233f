"""Device ms per step in the program's ``meta`` span: the sort metadata
and the gathers into the unique buffer (``forward_meta``; the column
path's gathers).  Read from the span's marks
(``utils/profiling.span_totals`` after the traced window less before
it), which a traced run turns on; None where the step has no such span."""


def read(run):
    return run.spans.get("meta")
