"""Device ms per step in the program's ``inputs`` span: the batch copied
into the captured graph's static inputs (``CapturedStep._donated``,
eager, before the replay).  Read from the span's marks
(``utils/profiling.span_totals`` after the traced window less before
it), which a traced run turns on; None where the step has no such span."""


def read(run):
    return run.spans.get("inputs")
