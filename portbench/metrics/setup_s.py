"""setup_s: seconds from the process's start to the first timed unit:
imports, the kernel library's build or load, the weights and traffic drawn
on the card, the warm-up at the cell's shapes (host clock)."""


def read(run):
    return run.setup_s
