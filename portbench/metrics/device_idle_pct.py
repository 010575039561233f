"""The share of the traced steps' time on the device (``Trace.steps_s``:
the first device operation to the last, less the profiler's own buffer
fetches) in which no kernel or copy ran on the card, in percent."""


def read(run):
    if not run.trace.steps_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.steps_s)
