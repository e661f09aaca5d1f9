"""Set-up: from the process's start to the window's (imports, the seeded
files and pool, the program's loaders, the kernels' first build or load,
the warm-up of every shape)."""


def read(run):
    return run["setup_s"]
