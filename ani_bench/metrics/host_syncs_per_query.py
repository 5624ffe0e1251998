"""Host syncs the program counted inside its spans (``host_syncs``:
torch's sync-debug warnings while profiling is on, less those outside
every span) per query of the window; the counts by scope go to standard
error."""

from ani_bench.lib.spans import log_syncs, program_syncs


def read(w):
    syncs = program_syncs(w.program)
    if w.unit != "pairs" or "hits" not in w.facts or syncs is None \
            or not w.calls:
        return None
    log_syncs(w.program)
    return syncs / len(w.calls)
