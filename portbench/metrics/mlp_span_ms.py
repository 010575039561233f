"""Device ms per step in the program's ``mlp`` span: the MLP, its
forward and its backward together (the backward from a gradient hook on
its output to one on its input).  Read from the span's marks
(``utils/profiling.span_totals`` after the traced window less before
it), which a traced run turns on; None where the step has no such span."""


def read(run):
    return run.spans.get("mlp")
