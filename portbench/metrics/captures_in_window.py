"""CUDA-graph captures the entry point made inside the traced window:
``CapturedStep.captures`` after the window less before it.  Each is a
recapture (a new batch signature or a replaced state) that stalls a
step."""


def read(run):
    return run.captures
