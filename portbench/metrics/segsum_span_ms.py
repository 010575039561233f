"""Device ms per step in the program's ``segsum`` span: the segment sums
of the gradients by unique id (``backward_sums``; the column path's sums
and split).  Read from the span's marks (``utils/profiling.span_totals``
after the traced window less before it), which a traced run turns on;
None where the step has no such span."""


def read(run):
    return run.spans.get("segsum")
