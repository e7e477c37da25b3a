"""device (H100): the share of the traced frames' span that no device
record (kernel, copy or fill) covers, in percent."""


def read(rec):
    tr = rec.trace
    if tr is None or tr.window_ns <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_ns() / tr.window_ns)
