"""Set-up seconds: from process start to the window's start (genomes
made, sketched, shapes warmed up)."""


def read(w):
    return w.setup_s
