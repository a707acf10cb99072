"""Audio seconds of the training set, summed over the EM iterations
completed in the window, over the window's wall time."""

def read(run):
    audio = [a for kind, a, _lat in run.requests if kind == "train"]
    if not audio or run.window_s <= 0:
        return None
    return sum(audio) / run.window_s
