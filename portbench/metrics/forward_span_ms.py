"""Device ms per step in the program's ``forward`` span: the model's
forward and loss (``call_rows`` / ``apply_batch``, ``model.loss``), the
MLP's forward with it.  Read from the span's marks
(``utils/profiling.span_totals`` after the traced window less before
it), which a traced run turns on; None where the step has no such span."""


def read(run):
    return run.spans.get("forward")
