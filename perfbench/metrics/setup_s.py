"""Set-up: process start to the window's opening (torch and the port
imported, the kernel library built or loaded, the weights made, the first
requests prefilled, the decode step captured)."""
LAYER = None
MOVES = None


def read(run):
    return run.setup_s
