"""Arcs of the returned lattices per frame and utterance: the lattice
generation's work count, which moves only when pruning does."""

def read(run):
    frames = run.counters.get("frames", 0)
    if not frames or "survivor_arcs" not in run.counters:
        return None
    return run.counters["survivor_arcs"] / frames
