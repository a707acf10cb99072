"""Audio seconds (frames x 10 ms) of the decode requests completed in the
window, over the window's wall time."""

def read(run):
    audio = [a for kind, a, _lat in run.requests if kind == "decode"]
    if not audio or run.window_s <= 0:
        return None
    return sum(audio) / run.window_s
