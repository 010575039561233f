"""Device ms per step in the program's ``update`` span: the optimizer
updates: the dense leaves and every table's lazy update.  Read from the
span's marks (``utils/profiling.span_totals`` after the traced window
less before it), which a traced run turns on; None where the step has no
such span."""


def read(run):
    return run.spans.get("update")
