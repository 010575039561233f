"""Device ms per step in the program's ``expand`` span: the unique rows
expanded to the batch's positions (``buf.to(dtype)[uidx]``; the column
path's transposed take).  Read from the span's marks
(``utils/profiling.span_totals`` after the traced window less before
it), which a traced run turns on; None where the step has no such span."""


def read(run):
    return run.spans.get("expand")
