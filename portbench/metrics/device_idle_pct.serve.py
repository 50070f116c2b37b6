"""The device in serving: the share of the traced window with no operation
running on the card, in percent."""


def read(trace, outcome, run):
    if not outcome.window.get("requests"):
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
